"""What decides ``correct``: the window's last call held to the plain
reference (:mod:`benchmark.reference`), after the window has closed.

The program logs each step's pose, commands, acceptance, status, primal
residual and violation floor, not the solver iterate it carries to the
next step.  So the reference checks the start of each rollout whole (every
sampled lane's first step, from the start state the benchmark made, the
carried iterate included), and follows a sample of lanes step by step from
the program's logged poses, carrying its own iterate and plan (the plan
follows the program's acceptance).  The numbers compared, each against
its limit (``benchmark/limits/<cell>.json``; the others found are printed
with the run's diagnostics), by the traffic's kind
(``benchmark/kinds/``):

* ``pose_gap``: every active lane-step of the call: the largest gap
  between the logged pose and progress (x, y, psi, s) and the reference's
  plant step from the logged pre-step pose with the logged commands
  (locate, the plant, the log);
* ``accept_rule_gap``: the share of the call's active lane-steps whose
  logged acceptance is not the configuration's rule (not diverged, and the
  primal residual within ``feas_tol`` plus the floor) applied to the
  logged status, residual and floor, in the configuration's float32;
* ``v0_gap_p99``, ``delta0_gap_p50``, ``r_prim0_gap_p99``: the first step
  of ``start_lanes`` lanes drawn from the seed: the 99th percentile of the
  speed-command gaps, the median of the steering gaps and the 99th
  percentile of the primal-residual gaps to the reference's (corridor, QP
  assembly, the solve, accept / replay; the largest gap belongs to the
  least converged lane and swings from seed to seed);
* ``floor_gap``: the largest gap of the violation floor over the first
  step of those lanes and every active step of ``check_lanes`` lanes (the
  corridor and the floor: no warm start enters it, so it holds at every
  step, on maps found as they go too);
* ``v_gap_p50``: the median speed-command gap over the active steps of
  the ``check_lanes`` lanes before the reference's carried step size
  first passes ``RHO_CUT`` in the lane (the same layers, warm started:
  past that, a float32 solve from the same iterate parts from the float64
  one by up to 1e-2, and the closed loop carries the difference on);
* per kind: ``map_gap`` (LiDAR fleets), the followed lanes' final known
  maps against the reference's, rebuilt by its own scans from the logged
  poses; the object API's ``delta_gap`` and ``accept_gap``
  (:mod:`benchmark.kinds.api_loop`).

The control (``low=True``) is the reference put in the program's place at
bfloat16 working precision: at the program's own pre-step states, every
quantity it stores is rounded to bfloat16 and its QPs are solved in
float32 (as bfloat16 products accumulate), and its answers are held to the
float64 reference by the same numbers."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import admm as A
from benchmark.reference import follow as F
from benchmark.reference import world as W

F64 = torch.float64
LIMITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "limits")
RHO_CUT = 1e3


def limits(cell: str) -> dict:
    with open(os.path.join(LIMITS, f"{cell}.json")) as f:
        return json.load(f)


def pre_states(start, log):
    """(T, B) pre-step x, y, psi, s: the start, then each logged step."""
    f = lambda a, b: torch.cat([a[None], b[:-1]]).to(F64)
    return (f(start.x, log.x), f(start.y, log.y), f(start.psi, log.psi),
            f(start.s, log.s))


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(F64)


def plant_gap(w, model, pre, post, cmds, active, low=False) -> float:
    """The largest gap of the logged post-step poses (or, ``low``, the
    control's plant step) to the reference's plant step."""
    if low:
        cmds = tuple(bf16(c) for c in cmds)
        post = tuple(bf16(p) for p in W.plant(w, model["length"], model["Ts"],
                                              *(bf16(p) for p in pre), *cmds))
    ref = W.plant(w, model["length"], model["Ts"], *pre, *cmds)
    gap = torch.stack([(a - b).abs() for a, b in zip(post, ref)]).amax(0)
    return float(torch.where(active, gap, torch.zeros_like(gap)).max())


class Answer(NamedTuple):
    """A step's answers of L lanes (or, stacked, (T, L) of a follow)."""

    v: torch.Tensor
    delta: torch.Tensor
    accepted: torch.Tensor
    floor: torch.Tensor
    r_prim: torch.Tensor
    rho: torch.Tensor  # the step size carried into the step


class Follower:
    """The reference controller of L lanes: its own solver carry and its
    plan, the plan following the program's acceptance.  ``low``: the
    control, at bfloat16 working precision."""

    def __init__(self, w: W.World, cfg: dict, wp0: torch.Tensor,
                 fused: bool = True, low: bool = False):
        self.w, self.cfg, self.mpc = w, cfg, cfg["mpc"]
        self.s = self.mpc["solver"]
        self.N = N = self.mpc["N"]
        self.L = cfg["model"]["length"]
        self.sm = cfg["model"]["width"] / 2 ** 0.5
        self.kmax = float(np.tan(self.mpc["delta_max"]) / self.L)
        self.fused, self.low = fused, low
        self.q = bf16 if low else (lambda t: t)
        dev = wp0.device
        n = wp0.shape[0]
        self.plan = torch.zeros((n, N, 2), dtype=F64, device=dev)
        self.plan[..., 0] = self.q(w.v_ref[W.horizon_index(
            w, wp0, torch.arange(N, device=dev))])
        self.count = torch.zeros(n, dtype=torch.long, device=dev)
        self.carry = A.fresh(n, N, self.s["rho"], dev)
        self.scan = F.scanlines(w, self.mpc["n_scan_samples"])
        self.static = None

    def static_segments(self):
        if self.static is None:
            px, py, cx, cy = self.scan
            free = W.read_occ(self.w.occ, px, py) > 0.5
            self.static = F.free_runs(free, cx, cy, 2 * self.sm,
                                      self.mpc["max_segments"])
        return self.static

    def solve(self, qp):
        if not self.low:
            return A.solve(qp, self.carry, self.s)
        f32 = lambda t: self.q(t).float()
        qp32 = A.QP(*(f32(getattr(qp, k.name)) for k in
                      dataclasses.fields(A.QP)))
        c32 = A.Carry(*(getattr(self.carry, k.name).float() for k in
                        dataclasses.fields(A.Carry)))
        c, rp, rd = A.solve(qp32, c32, self.s)
        return (A.Carry(*(self.q(getattr(c, k.name).double()) for k in
                          dataclasses.fields(A.Carry))),
                rp.double(), rd.double())

    def step(self, x, y, psi, s, ok, maps=None) -> Answer:
        """The reference's answers at these poses; its plan follows the
        program's acceptance ``ok``.  ``maps``: per-lane known maps (L, H,
        W), else the static map."""
        w, N, mpc, q = self.w, self.N, self.mpc, self.q
        rho_in = self.carry.rho
        x, y, psi, s = q(x), q(y), q(psi), q(s)
        wp = W.locate(w, s)
        e_y, e_psi = (q(t) for t in W.spatial(w, wp, x, y, psi))
        offs = torch.arange(N, device=x.device)
        dyn = W.horizon_index(w, wp, offs)
        cor = W.horizon_index(w, wp, offs + 1)
        if maps is None:
            u, l, v = (t[cor] for t in self.static_segments())
        else:
            px, py, cx, cy = (t[cor] for t in self.scan)
            free = F.read_maps(maps, px, py) > 0.5
            u, l, v = F.free_runs(free, cx, cy, 2 * self.sm,
                                  mpc["max_segments"])
        ub, lb = (q(t) for t in F.select(w, cor, u, l, v, self.sm))
        vr, kr, ds = q(w.v_ref[dyn]), q(w.kappa[dyn]), q(w.seg_dist[dyn])
        fl = F.floor(e_y, e_psi, kr, ds, lb, ub, self.kmax)
        kp = self.plan[:, torch.clamp(offs + 1, max=N - 1), 1]
        qp = A.horizon_qp(mpc, self.kmax, e_y, e_psi, vr, kr, ds, lb, ub, kp)
        carry, rp, rd = self.solve(qp)
        if self.fused:
            ctr = (lb + ub) / 2
            qmax = torch.maximum(
                ctr.abs().amax(1) * max(mpc["Q"][0], mpc["QN"][0]),
                torch.maximum(vr.abs().amax(1) * mpc["R"][0],
                              kr.abs().amax(1) * mpc["R"][1]))
        else:
            qmax = qp.q.abs().amax(1)
        st, self.carry = A.status(carry, rp, rd, qmax, self.s)
        slack = fl if mpc["least_violation_accept"] else 0.0
        accepted = (st != A.DIVERGED) & (rp <= mpc["feas_tol"] + slack)
        U = carry.z[:, 3 * (N + 1):].reshape(-1, N, 2)
        rows = torch.arange(x.shape[0], device=x.device)
        replay = self.plan[rows, torch.clamp(self.count + 1, max=N - 1)]
        v_cmd = torch.where(ok, U[:, 0, 0], replay[:, 0])
        k_cmd = torch.where(ok, U[:, 0, 1], replay[:, 1])
        self.plan = torch.where(ok[:, None, None], U, self.plan)
        self.count = torch.where(ok, torch.zeros_like(self.count),
                                 self.count + 1)
        return Answer(q(v_cmd), q(torch.atan(k_cmd * self.L)), accepted, fl,
                      rp, rho_in)


def lane_sample(seed: int, stream: int, B: int, n: int, device):
    from benchmark.drivers import rng

    return torch.as_tensor(np.sort(rng(seed, stream).choice(
        B, min(B, n), replace=False)), device=device)


def follow(w, cfg, start, log, lanes, lidar=None, low=False, shared=None):
    """The reference (or the control) along ``lanes`` from the program's
    pre-step poses: ``(Answer of (T, L) each, maps)``.  ``lidar``: each
    lane reads its own known map, all free at the start and rebuilt as it
    goes by its own scans (returned, (L, H, W)); ``shared``: every lane
    reads the one map ``shared[t]`` (T, H, W) at step t; else the static
    map."""
    T = log.x.shape[0]
    x, y, psi, s = (t[:, lanes] for t in pre_states(start, log))
    f = Follower(w, cfg, start.wp_id[lanes].long(), low=low)
    maps = None
    if lidar is not None:
        maps = torch.ones((len(lanes),) + tuple(w.occ.shape), dtype=F64,
                          device=x.device)
        cells = F.boundary_cells(w.occ)
    out = []
    for t in range(T):
        if maps is not None:
            F.write_hits(maps, F.scan_hits(w, cells, lidar, f.q(x[t]),
                                           f.q(y[t]), f.q(psi[t])))
        out.append(f.step(x[t], y[t], psi[t], s[t], log.ok[t, lanes],
                          maps if shared is None else shared[t]))
    return Answer(*(torch.stack(a) for a in zip(*out))), maps


def accept_rule(log, mpc: dict) -> torch.Tensor:
    """The configuration's acceptance of the logged solves, in float32."""
    slack = (log.floor if mpc["least_violation_accept"]
             else torch.zeros_like(log.floor))
    return (log.status != A.DIVERGED) & (log.r_prim <= mpc["feas_tol"] + slack)


def share(mask: torch.Tensor, of: torch.Tensor) -> float:
    return float((mask & of).sum()) / max(1, int(of.sum()))


def call_numbers(w, cfg, start, log, low=False) -> dict:
    """``pose_gap`` and ``accept_rule_gap`` over the whole call (the
    control's plant; its acceptance is the rule's by construction)."""
    pre = pre_states(start, log)
    post = tuple(getattr(log, k).to(F64) for k in ("x", "y", "psi", "s"))
    cmds = (log.v.to(F64), log.delta.to(F64))
    rule = accept_rule(log, cfg["mpc"])
    return {"pose_gap": plant_gap(w, cfg["model"], pre, post, cmds,
                                  log.active, low),
            "accept_rule_gap": 0.0 if low else share(log.ok != rule,
                                                     log.active)}


def quantile(t: torch.Tensor, q: float) -> float:
    return float(torch.quantile(t, q)) if t.numel() else 0.0


def start_numbers(w, cfg, start, log, seed, n, lidar=None, low=False,
                  shared=None) -> dict:
    """The first step of ``n`` lanes drawn from the seed.  ``shared``: the
    shared maps ``(reference's, control's)`` that every lane reads (see
    :func:`follow`)."""
    first = lane_sample(seed, 1, log.x.shape[1], n, log.x.device)
    one = type(log)(*(f[:1] for f in log))
    ref_maps, low_maps = shared if shared is not None else (None, None)
    ref, _ = follow(w, cfg, start, one, first, lidar, shared=ref_maps)
    if low:
        got, _ = follow(w, cfg, start, one, first, lidar, low=True,
                        shared=low_maps)
        v, d, rp, fl = got.v[0], got.delta[0], got.r_prim[0], got.floor[0]
    else:
        v, d, rp, fl = (getattr(log, k)[0, first].to(F64)
                        for k in ("v", "delta", "r_prim", "floor"))
    act = log.active[0, first]
    gv, gd = (v - ref.v[0]).abs()[act], (d - ref.delta[0]).abs()[act]
    return {"v0_gap_p99": quantile(gv, 0.99),
            "delta0_gap_p50": quantile(gd, 0.5),
            "r_prim0_gap_p99": quantile((rp - ref.r_prim[0]).abs()[act], 0.99),
            "floor_gap": float((fl - ref.floor[0]).abs()[act].max())
            if bool(act.any()) else 0.0,
            "v0_gap": float(gv.max()) if gv.numel() else 0.0,
            "delta0_gap": float(gd.max()) if gd.numel() else 0.0}


@dataclasses.dataclass
class Maps:
    ref: torch.Tensor  # the reference's known maps of the followed lanes
    low: torch.Tensor  # the control's


def follow_numbers(w, cfg, start, log, lanes, lidar=None, low=False,
                   shared=None):
    """``({v_gap_p50, floor_gap}, (lanes, Maps))`` of the followed lanes
    (``shared``: as :func:`start_numbers` takes it)."""
    ref_maps, shared_low = shared if shared is not None else (None, None)
    ref, maps = follow(w, cfg, start, log, lanes, lidar, shared=ref_maps)
    act = log.active[:, lanes]
    low_maps = None
    if low:
        got, low_maps = follow(w, cfg, start, log, lanes, lidar, low=True,
                               shared=shared_low)
        v, fl = got.v, got.floor
    else:
        v, fl = log.v[:, lanes].to(F64), log.floor[:, lanes].to(F64)
    clean = act & (torch.cummax((ref.rho > RHO_CUT).int(), 0).values == 0)
    gv = (v - ref.v).abs()
    found = {"v_gap_p50": quantile(gv[clean], 0.5),
             "floor_gap": float((fl - ref.floor).abs()[act].max())
             if bool(act.any()) else 0.0,
             "v_gap_p50_all": quantile(gv[act], 0.5),
             "v_gap_steps": int(clean.sum())}
    return found, (lanes, Maps(maps, low_maps))


def check(driver, cfg: dict, root: str, seed: int, cell: str,
          low: bool = False) -> dict:
    """``{name: (value, limit)}`` of the window's last call (``low``: of
    the control put in the program's place)."""
    lim = limits(cell)
    t0 = time.perf_counter()
    w = W.build_world(cfg, root, driver.device)
    t1 = time.perf_counter()
    found = driver.numbers(w, cfg, seed, low)
    info = getattr(driver, "check_info", {})
    info.update(world_s=t1 - t0, numbers_s=time.perf_counter() - t1,
                candidates={k: v for k, v in found.items() if k not in lim})
    driver.check_info = info
    return {k: (v, lim[k]) for k, v in found.items() if k in lim}
