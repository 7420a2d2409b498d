"""``fleet`` traffic: ``simulation.simulate_fleet`` rollouts of ``batch``
lanes x ``steps`` steps.  ``static_grid``: the static grid's path (the
horizon table, K2, K1), else the dynamic grid's (K4, the free runs, K2
and K1 every step).  The window cycles through ``pool`` start sets drawn
once in set-up by ``feasible_starts`` (``e_y_scale``) from the seed; each
call is the repeated call of the cached CUDA graphs, on fresh inputs.

Held to the reference (:mod:`benchmark.checks`): ``pose_gap`` and
``accept_rule_gap`` over the whole call, the first step of
``start_lanes`` lanes, and ``check_lanes`` lanes followed step by step."""

from __future__ import annotations

import time

import torch

from benchmark import checks
from benchmark import scenario as scn
from benchmark.drivers import Window, log_counts, rng, sync


class Driver:
    lidar = None  # the configuration's LiDAR, for a kind that scans

    def __init__(self, sc: scn.Scenario, traffic: dict, seed: int,
                 device="cuda"):
        from multi_purpose_mpc_tpu_torch.config import SimConfig
        from multi_purpose_mpc_tpu_torch.simulation import (feasible_starts,
                                                            init_fleet)

        self.sc, self.traffic, self.device = sc, traffic, device
        self.B, self.T = traffic["batch"], traffic["steps"]
        self.grid, self.path = scn.world(sc, device)
        self.sim = SimConfig(max_steps=self.T,
                             static_grid=traffic.get("static_grid", False))
        self.prepare()
        draw = rng(seed)
        self.pool = []
        for _ in range(traffic["pool"]):
            wp, ey = feasible_starts(self.grid, self.path, sc.mpc, sc.model,
                                     self.B, draw,
                                     e_y_scale=traffic["e_y_scale"])
            self.pool.append(init_fleet(self.path, sc.mpc.N, self.B, e_y0=ey,
                                        wp_id0=wp))
        self.calls = 0
        self.failed = 0
        self.last = None  # (start state, SimResult, final maps or None)

    def prepare(self):
        from multi_purpose_mpc_tpu_torch.ops.corridor_extract import (
            build_scanline_table)
        from multi_purpose_mpc_tpu_torch.simulation import static_horizon_table

        sc = self.sc
        self.table = (static_horizon_table(self.grid, self.path, sc.mpc,
                                           sc.model) if self.sim.static_grid
                      else build_scanline_table(self.grid, self.path,
                                                sc.mpc.n_scan_samples))

    def rollout(self, start):
        """``(SimResult, final maps or None)`` of one call."""
        from multi_purpose_mpc_tpu_torch.simulation import simulate_fleet

        sc = self.sc
        return simulate_fleet(self.grid, self.path, sc.mpc, sc.model,
                              self.sim, start, table=self.table), None

    def call(self):
        start = self.pool[self.calls % len(self.pool)]
        self.calls += 1
        res, occ = self.rollout(start)
        self.last = (start, res, occ)
        return res

    def warm_up(self):
        """The first call, which captures the graphs, and a repeated one."""
        self.call()
        self.call()
        sync(self.device)

    def window(self, seconds: float) -> Window:
        counts = torch.zeros(3, dtype=torch.int64, device=self.device)
        sync(self.device)
        t0 = time.perf_counter()
        calls = 0
        while True:
            counts += log_counts(self.call().log)
            calls += 1
            sync(self.device)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        acc, act, fail = counts.tolist()
        return Window(elapsed, calls, calls * self.B * self.T, acc, act, fail,
                      [], [])

    def traced_calls(self, n: int):
        def run():
            for _ in range(n):
                self.call()
        return run

    def shapes(self) -> dict:
        s = self.sc.mpc.solver
        return dict(B=self.B, N=self.sc.mpc.N, K=self.sc.mpc.n_scan_samples,
                    iterations=s.iterations, rho_updates=s.rho_updates,
                    polish_iters=s.polish_iters, stage_solver=s.stage_solver,
                    nb=self.sc.lidar.n_beams)

    def numbers(self, w, cfg: dict, seed: int, low: bool = False) -> dict:
        start, res, _ = self.last
        out = checks.call_numbers(w, cfg, start, res.log, low)
        first = checks.start_numbers(w, cfg, start, res.log, seed,
                                     self.traffic["start_lanes"], self.lidar,
                                     low)
        lanes = checks.lane_sample(seed, 2, self.B,
                                   self.traffic["check_lanes"],
                                   res.log.x.device)
        found, self.followed = checks.follow_numbers(
            w, cfg, start, res.log, lanes, self.lidar, low)
        found["floor_gap"] = max(found["floor_gap"], first.pop("floor_gap"))
        return {**out, **first, **found}
