"""``api_loop`` traffic: one car through the object API, ``get_control``
then ``drive``, back to back (a closed loop: the next cycle starts when
the last has returned).  At the path end (upstream's loop condition) the
car is set back, outside the timed cycle, to a start waypoint drawn from
the seed (``restart_share``: the share of the path the draws cover).

Held to the reference: ``pose_gap`` over every cycle of the window, and
``delta_gap`` over ``check_cycles`` cycles drawn from the seed, each from
the program's own pre-cycle state (its solver iterate, plan and replay
count included).  ``accept_gap``, the share of those cycles whose
acceptance differs, is found too; its limit file leaves it out while
every solve of the traffic is accepted, the control's too."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks
from benchmark import scenario as scn
from benchmark.drivers import Window, rng, sync
from benchmark.reference import admm as A
from benchmark.reference import world as W

F64 = torch.float64


class Driver:
    B = T = 1

    def __init__(self, sc: scn.Scenario, traffic: dict, seed: int,
                 device="cuda"):
        from multi_purpose_mpc_tpu_torch import api

        self.sc, self.traffic, self.device = sc, traffic, device
        m, p, cfg = sc.map_cfg, sc.path_cfg, sc.mpc
        self.map = api.Map(m.file_path, m.origin, m.resolution,
                           threshold_occupied=m.threshold_occupied,
                           device=device)
        self.rp = api.ReferencePath(self.map, p.wp_x, p.wp_y, p.resolution,
                                    p.smoothing_distance, p.max_width,
                                    p.circular)
        if sc.obstacles:
            self.map.add_obstacles([api.Obstacle(*o) for o in sc.obstacles])
        self.car = api.BicycleModel(self.rp, sc.model.length, sc.model.width,
                                    sc.model.Ts)
        kmax = np.tan(cfg.delta_max) / sc.model.length
        self.mpc = api.MPC(
            self.car, cfg.N, np.diag(cfg.Q), np.diag(cfg.R), np.diag(cfg.QN),
            {"xmin": np.asarray(cfg.xmin), "xmax": np.asarray(cfg.xmax)},
            {"umin": np.array([cfg.v_min, -kmax]),
             "umax": np.array([cfg.v_max, kmax])}, cfg.ay_max,
            solver=cfg.solver)
        self.rp.compute_speed_profile(sc.speed)
        self.length = self.rp.length
        n = self.rp.n_waypoints
        share = traffic["restart_share"]
        self.starts = rng(seed).integers(0, max(1, int(n * share)), 256)
        self.restarts = 0
        self.records = []  # (pre state, (v, delta), accepted, post state)
        self.failed = 0
        self.restart()

    def restart(self):
        wp = self.rp.get_waypoint(int(self.starts[self.restarts
                                                  % len(self.starts)]))
        self.restarts += 1
        self.car.set_pose(wp.x, wp.y, wp.psi)

    def cycle(self, keep: bool):
        """One timed cycle: ``(cycle s, get_control s, accepted)``."""
        pre = self.car.state
        t0 = time.perf_counter()
        try:
            u = self.mpc.get_control()
        except RuntimeError:  # N - 1 consecutive infeasible QPs
            self.failed += 1
            self.restart()
            return None
        t1 = time.perf_counter()
        self.car.drive(u)
        sync(self.device)
        t2 = time.perf_counter()
        accepted = self.mpc.infeasibility_counter == 0
        if keep:
            self.records.append((pre, u, accepted, self.car.state))
        if self.car.s >= self.length:  # upstream's loop condition
            self.restart()
        return t2 - t0, t1 - t0, accepted

    def warm_up(self):
        for _ in range(self.traffic["warm_up_cycles"]):
            self.cycle(False)
        self.restart()
        sync(self.device)

    def window(self, seconds: float) -> Window:
        cyc, gc, acc = [], [], 0
        sync(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            out = self.cycle(True)
            if out is None:
                continue
            cyc.append(out[0])
            gc.append(out[1])
            acc += out[2]
        elapsed = time.perf_counter() - t0
        n = len(cyc) + self.failed
        return Window(elapsed, n, n, acc, n, 0, cyc, gc)

    def traced_calls(self, n: int):
        def run():
            for _ in range(n):
                self.cycle(True)
        return run

    def shapes(self) -> dict:
        s = self.sc.mpc.solver
        return dict(B=1, N=self.sc.mpc.N, K=self.sc.mpc.n_scan_samples,
                    iterations=s.iterations, rho_updates=s.rho_updates,
                    polish_iters=s.polish_iters, stage_solver=s.stage_solver,
                    nb=self.sc.lidar.n_beams)

    def numbers(self, w, cfg: dict, seed: int, low: bool = False) -> dict:
        recs = self.records
        st = lambda s, k: torch.stack([getattr(x, k)[0] for x in s]).to(F64)
        pre = tuple(st([r[0] for r in recs], k) for k in ("x", "y", "psi", "s"))
        post = tuple(st([r[3] for r in recs], k)
                     for k in ("x", "y", "psi", "s"))
        u = torch.as_tensor(np.array([r[1] for r in recs]), dtype=F64,
                            device=pre[0].device)
        active = torch.ones_like(pre[0], dtype=torch.bool)
        out = {"pose_gap": checks.plant_gap(w, cfg["model"], pre, post,
                                            (u[:, 0], u[:, 1]), active, low)}
        pick = checks.lane_sample(seed, 1, len(recs),
                                  self.traffic["check_cycles"], pre[0].device)
        sub = [recs[i][0] for i in pick.tolist()]
        ok = torch.as_tensor([bool(recs[i][2]) for i in pick.tolist()],
                             device=pick.device)

        def run(low_):
            f = checks.Follower(w, cfg, W.locate(w, pre[3][pick]), fused=False,
                                low=low_)
            N, n = f.N, len(sub)
            sv = lambda k: torch.stack([getattr(r.solver, k)[0].reshape(-1)
                                        for r in sub]).to(F64)
            f.plan = f.q(torch.stack([r.u_seq[0] for r in sub]).to(F64)
                         .reshape(n, N, 2))
            f.count = torch.stack([r.infeasibility_count[0]
                                   for r in sub]).long()
            f.carry = A.Carry(torch.cat([sv("X"), sv("U")], 1),
                              torch.cat([sv("Zx"), sv("Zu")], 1), sv("Yeq"),
                              torch.cat([sv("Yx"), sv("Yu")], 1),
                              torch.stack([r.solver.rho[0]
                                           for r in sub]).to(F64))
            return f.step(*(p[pick] for p in pre), ok)

        ref = run(False)
        if low:
            got = run(True)
            v, d, acc = got.v, got.delta, got.accepted
        else:
            v, d, acc = u[pick, 0], u[pick, 1], ok
        gv, gd = (v - ref.v).abs(), (d - ref.delta).abs()
        out["delta_gap"] = float(gd.max())
        out["accept_gap"] = float((acc != ref.accepted).double().mean())
        self.check_info = {"v_gap": float(gv.max()),
                           "v_gap_p50": float(gv.median()),
                           "delta_gap_p50": float(gd.median())}
        return out
