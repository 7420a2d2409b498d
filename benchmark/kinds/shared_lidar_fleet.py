"""``shared_lidar_fleet`` traffic: one LiDAR mapping fleet of ``batch``
lanes split over ``ranks`` processes, one card each
(``parallel.fleet.simulate_lidar_fleet_sharded`` with ``shared_grid`` and
``clear_free``), x ``steps`` steps a call.  Every rank holds a copy of the
one shared map, all free at the start of each call; every step each rank
scans with its lanes (K7), forms its hit and free masks, pools them over
the ranks (one MAX all-reduce a mask class), updates its copy and runs the
dynamic-grid step on it (K4, K8, K2, K1).  The scan's cell table is the
program's own (``simulation.resolve_cell_table``), as the ``lidar_fleet``
kind's.  Starts and calls as the ``fleet`` kind's, drawn on every rank and
taken from rank 0's draws, so each rank runs its block of the same
lanes.

``B`` and the work are the whole fleet's lanes: a call is every rank's
call together.  Rank 0 decides when the window ends and tells the others
after each call (one broadcast over the host); one call is in flight
while the host waits for the one before.  ``shapes`` and ``k7_in_range``
are rank 0's own, which its traced kernels see.

Held to the reference after the window: ``gather`` assembles the last
call's logs of every rank (``parallel.fleet.gather_fleet``) and every
rank's final map, and rank 0 compares them with the numbers of the
``fleet`` kind (``pose_gap``, ``accept_rule_gap``, ``v0_gap_p99``,
``delta0_gap_p50``, ``floor_gap``, ``v_gap_p50``), its followed lanes
reading the shared map that the reference rebuilds at every step from all
lanes' logged poses (:mod:`benchmark.reference.shared`), and ``map_gap``:
the widest share of differing cells between a rank's final map and the
reference's."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from benchmark import checks
from benchmark.drivers import Window, log_counts, sync
from benchmark.kinds import lidar_fleet
from benchmark.reference import shared as S

F64 = torch.float64


class Driver(lidar_fleet.Driver):

    def __init__(self, sc, traffic: dict, seed: int, device="cuda"):
        from multi_purpose_mpc_tpu_torch.parallel.mesh import (
            global_fleet_mesh)
        from multi_purpose_mpc_tpu_torch.utils.tree import leaves, tree_map

        self.mesh = mesh = global_fleet_mesh(device)
        if mesh.group is None or mesh.world_size != traffic["ranks"]:
            raise ValueError(f"{traffic['name']} runs on {traffic['ranks']} "
                             f"ranks, not {mesh.world_size}")
        super().__init__(sc, traffic, seed, device)
        self.control = dist.new_group(backend="gloo")
        self.pool = [tree_map(lambda t: t.contiguous(), p) for p in self.pool]
        for start in self.pool:
            for leaf in leaves(start):
                dist.broadcast(leaf, 0, group=mesh.group)
        self.full = self.final_maps = None

    def rollout(self, start):
        from multi_purpose_mpc_tpu_torch.parallel import fleet as pfleet

        sc = self.sc
        return pfleet.simulate_lidar_fleet_sharded(
            self.mesh, self.grid, self.known, self.path, sc.mpc, sc.model,
            self.sim, sc.lidar, start, clear_free=True, shared_grid=True,
            scan_backend="cells", table=self.table, cells=self.cells)

    def window(self, seconds: float) -> Window:
        """Calls back to back with one in flight: the host enqueues call k,
        then waits for the end of call k-1, and rank 0 tells every rank
        over the host (the gloo group ``control``) whether the window is
        over by then.  So no rank's host work between calls sits on the
        cards' path, and the window ends with the end of its last call."""
        group = self.mesh.group
        counts = torch.zeros(3, dtype=torch.int64, device=self.device)
        stop = torch.zeros(1, dtype=torch.int32)
        sync(self.device)
        dist.barrier(group=group)
        t0 = time.perf_counter()
        ends, ended = [], []  # events of calls in flight; host end times
        calls = 0
        while True:
            counts += log_counts(self.call().log)
            calls += 1
            ends.append(end_of_call(self.device))
            if len(ends) > 1:
                done = ends.pop(0)
                if done is not None:
                    done.synchronize()
                ended.append(time.perf_counter())
            if self.mesh.rank == 0:
                stop.fill_(int(time.perf_counter() - t0 >= seconds))
            dist.broadcast(stop, 0, group=self.control)
            if stop.item():
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        dist.all_reduce(counts, group=group)
        acc, act, fail = counts.tolist()
        ms = sorted(1e3 * (b - a) for a, b in zip(ended, ended[1:]))
        if ms:
            self.check_info = {"call_ms": [ms[0], ms[len(ms) // 2], ms[-1]]}
        return Window(elapsed, calls, calls * self.B * self.T, acc, act, fail,
                      [], [])

    def traced_calls(self, n: int):
        from multi_purpose_mpc_tpu_torch.parallel.mesh import shard_fleet_state

        def run():
            for _ in range(n):
                res = self.call()
                self.traced_logs.append(
                    (shard_fleet_state(self.last[0], self.mesh), res.log))
        return run

    def shapes(self) -> dict:
        return dict(super().shapes(), B=self.B // self.mesh.world_size)

    def gather(self):
        """Every rank: the last call's whole fleet and every rank's final
        map, for the check on rank 0."""
        from multi_purpose_mpc_tpu_torch.parallel import fleet as pfleet

        _, res, occ = self.last
        self.full = pfleet.gather_fleet(res, self.mesh)
        mine = occ.to(torch.uint8).contiguous()
        if dist.get_backend(self.mesh.group) == dist.Backend.GLOO:
            mine = mine.cpu()
        maps = [torch.empty_like(mine) for _ in range(self.mesh.world_size)]
        dist.all_gather(maps, mine, group=self.mesh.group)
        self.final_maps = torch.stack(maps).to(occ.device)

    def numbers(self, w, cfg: dict, seed: int, low: bool = False) -> dict:
        start = self.last[0]
        log = self.full.log
        x, y, psi, _ = checks.pre_states(start, log)
        ref = S.shared_maps(w, self.lidar, x, y, psi)
        got = (S.shared_maps(w, self.lidar, *(checks.bf16(t) for t in
                                               (x, y, psi)))
               if low else None)
        out = checks.call_numbers(w, cfg, start, log, low)
        first = checks.start_numbers(w, cfg, start, log, seed,
                                     self.traffic["start_lanes"], low=low,
                                     shared=(ref, got))
        lanes = checks.lane_sample(seed, 2, self.B,
                                   self.traffic["check_lanes"], log.x.device)
        found, _ = checks.follow_numbers(w, cfg, start, log, lanes, low=low,
                                         shared=(ref, got))
        found["floor_gap"] = max(found["floor_gap"], first.pop("floor_gap"))
        out.update(first)
        out.update(found)
        prog = got[-1][None] if low else self.final_maps.to(F64)
        out["map_gap"] = (float((prog != ref[-1]).sum((1, 2)).amax())
                          / max(1, int((ref[-1] < 0.5).sum())))
        return out


def end_of_call(device):
    """An event at the end of the work enqueued so far (None on the CPU,
    where a call has ended when it returns)."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev
