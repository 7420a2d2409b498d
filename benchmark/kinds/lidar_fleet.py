"""``lidar_fleet`` traffic: ``simulation.simulate_lidar_fleet`` rollouts of
``batch`` lanes x ``steps`` steps, each lane's known map all free at the
start of every call: the ``cells`` scan (K7), the write-back and
extraction (K6 on the card), the free runs, K2, K1.  Starts and calls as
the ``fleet`` kind's.

Held to the reference as the ``fleet`` kind, the followed lanes reading
maps the reference rebuilds by its own scans, and ``map_gap``: those
lanes' final maps."""

from __future__ import annotations

import torch

from benchmark import checks
from benchmark import scenario as scn
from benchmark.kinds import fleet

F64 = torch.float64


class Driver(fleet.Driver):

    def prepare(self):
        from multi_purpose_mpc_tpu_torch.ops.corridor_extract import (
            build_scanline_table)
        from multi_purpose_mpc_tpu_torch.simulation import resolve_cell_table

        sc = self.sc
        self.lidar = sc.cfg["lidar"]
        self.table = build_scanline_table(self.grid, self.path,
                                          sc.mpc.n_scan_samples)
        self.known = scn.free_like(self.grid)
        self.cells = resolve_cell_table(self.grid, self.path, sc.lidar, None,
                                        "cells")
        self.traced_logs = []  # (start, log) of the traced calls

    def rollout(self, start):
        from multi_purpose_mpc_tpu_torch.simulation import simulate_lidar_fleet

        sc = self.sc
        return simulate_lidar_fleet(
            self.grid, self.known, self.path, sc.mpc, sc.model, self.sim,
            sc.lidar, start, table=self.table, cells=self.cells,
            scan_backend="cells")

    def traced_calls(self, n: int):
        def run():
            for _ in range(n):
                res = self.call()
                self.traced_logs.append((self.last[0], res.log))
        return run

    def shapes(self) -> dict:
        H, W = self.grid.occ.shape
        return dict(super().shapes(), H=H, W=W, WR=(H + 31) // 32)

    def k7_in_range(self):
        """``(in-range boundary cells summed over the traced scans,
        scans)``."""
        from benchmark.counts import k7

        grid = self.grid
        cells = k7.boundary_cells(grid.occ)
        origin = tuple(float(v) for v in grid.origin)
        res = float(grid.resolution)
        total, scans = 0, 0
        for start, log in self.traced_logs:
            xs = torch.cat([start.x[None], log.x[:-1]]).reshape(-1)
            ys = torch.cat([start.y[None], log.y[:-1]]).reshape(-1)
            total += k7.in_range(cells, origin, res, self.sc.lidar.range,
                                 xs, ys)
            scans += xs.shape[0]
        return (total, scans) if scans else None

    def numbers(self, w, cfg: dict, seed: int, low: bool = False) -> dict:
        out = super().numbers(w, cfg, seed, low)
        _, _, occ = self.last
        lanes, maps = self.followed
        prog = maps.low if low else occ[lanes].to(F64)
        out["map_gap"] = (int((prog != maps.ref).sum())
                          / max(1, int((maps.ref < 0.5).sum())))
        return out
