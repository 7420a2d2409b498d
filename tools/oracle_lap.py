"""The float64 oracle's runs in the JAX package's four oracle-held task
modes, as fixtures for the port's trajectory tests.

    python tools/oracle_lap.py [--scenario NAME] [--out FILE]

``NAME`` is one of :data:`SCENARIOS` (default ``convex``):

* ``convex``: tests/test_parity.py:67-84 — Sim_Track with its obstacles,
  Q = QN = (1, 0.1, 0), R = (0.5, 0.01), a 200 x 10 + 40 solver budget,
  the speed profile at v_max = 0.85, T = 260;
* ``time_optimal``: tests/test_parity_topt.py:42-58 — Sim_Track with its
  obstacles, ``time_optimal_config(t_weight=100, r_v=0.01, r_kappa=0.01)``,
  the 200 x 10 + 40 budget, the preset's speed profile, T = 160;
* ``real_seam``: tests/test_parity_real.py:39-70 — Real_Track (a
  non-circular path), the strictly convex weights of ``convex``, the
  200 x 10 + 40 budget, from s0 = L - 10.5 to the path end, T = 280;
* ``production``: tests/test_parity_production.py:42-60 — Sim_Track with
  its obstacles, the production weights and budget (30 x 6 + 10), v_max =
  0.85, T = 300; a free run, not pre-step states.

Each is built from the port's own objects on the CPU; the tool runs
``tests.oracle.sim.simulate_oracle(..., qp_solver="ip")`` on the port's
grid and path (~4 min each) and writes the run to ``FILE`` (default
``tests/data/torch_oracle_lap.npz`` for ``convex``,
``tests/data/torch_oracle_{NAME}.npz`` for the others):

* ``pre_x``, ``pre_y``, ``pre_psi``, ``pre_s`` (T,), ``pre_u`` (T, N, 2),
  ``pre_ic`` (T,): the oracle's exact state before every step;
* ``x``, ``y``, ``psi``, ``v``, ``delta``, ``s``, ``solved`` (T,): its logs;
* ``inputs_sha256``: a hash of everything the oracle read (the path
  arrays, the occupancy grid, the configs, T, K, S and a nonzero s0).

The per-step scenarios (``convex``, ``time_optimal``, ``real_seam``) drive
the port's fleet step from every pre-step state (:func:`port_step`) and
hold it to their JAX test's bars (:data:`BARS`, :func:`parity`,
:func:`misses`); ``production`` holds the port's free run to
tests/test_parity_production.py's bars (:func:`free_run`).  The task-mode
laps of tests/test_modes.py (no oracle) are :func:`mode_laps`.  Imports
numpy, torch and the port; no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from multi_purpose_mpc_tpu_torch.config import (  # noqa: E402
    SimConfig, SolverConfig, SpeedProfileConstraints, real_track_preset,
    sim_track_preset, time_optimal_config)
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops.speed_profile import (  # noqa: E402
    compute_speed_profile)
from multi_purpose_mpc_tpu_torch.utils.maps import (  # noqa: E402
    add_obstacles_host, load_grid_map)

DATA = os.path.join(REPO, "tests", "data")
LOGS = ("x", "y", "psi", "v", "delta", "s", "solved")
# the oracle tests' cranked budget: the solver well past its accept
# threshold, so the comparison measures the math, not the iteration budget
CRANKED = SolverConfig(iterations=200, rho_updates=10, polish_iters=40)
# strictly convex weights (tests/test_parity.py:74-75, test_parity_real.py:50)
CONVEX_W = dict(Q=(1.0, 0.1, 0.0), QN=(1.0, 0.1, 0.0), R=(0.5, 0.01))


@dataclasses.dataclass(frozen=True)
class Spec:
    """One oracle scenario: what its JAX test sets."""

    track: str  # "sim" (Sim_Track with its obstacles) or "real" (Real_Track)
    T: int  # the oracle's step budget
    weights: Optional[dict]  # MPCConfig fields replaced, None = preset's
    time_optimal: bool = False  # time_optimal_config(100, 0.01, 0.01) first
    solver: Optional[SolverConfig] = CRANKED  # None = production budget
    v_max: Optional[float] = None  # speed profile cap, None = preset's
    end_back: Optional[float] = None  # s0 = L - end_back
    min_steps: int = 0  # the oracle window the JAX test asserts
    per_step: bool = True  # pre-step states (else a free run)
    fixture: Optional[str] = None  # in tests/data, None = torch_oracle_{name}.npz


# each built as the JAX test builds it (module docstring: test and lines)
SCENARIOS = {
    "convex": Spec("sim", 260, CONVEX_W, v_max=0.85, min_steps=200,
                   fixture="torch_oracle_lap.npz"),
    "time_optimal": Spec("sim", 160, None, time_optimal=True, min_steps=100),
    "real_seam": Spec("real", 280, CONVEX_W, end_back=10.5, min_steps=200),
    "production": Spec("sim", 300, None, solver=None, v_max=0.85,
                       per_step=False),
}
PER_STEP = tuple(k for k, v in SCENARIOS.items() if v.per_step)


def fixture(name: str) -> str:
    """The path of the scenario's fixture."""
    return os.path.join(DATA, SCENARIOS[name].fixture
                        or f"torch_oracle_{name}.npz")


FIXTURE = fixture("convex")


@dataclasses.dataclass(frozen=True)
class Bars:
    """A per-step scenario's bars, copied from its JAX test."""

    traj: float = 1e-3  # v, x', y', s' on every step both accept
    both_min: float = 0.9  # share of the run both accept
    # "tight": interior optimum, primal residual below ``tight_rprim``, on
    # at least ``tight_min`` of the run; None: no tight subset held
    tight_rprim: Optional[float] = 1e-4
    tight_min: float = 0.8
    # (name, median, p90, tight max, max over the steps both accept); a
    # None bar is not held
    angles: tuple = (("delta", 2e-4, None, 5e-3, 1e-1),
                     ("psi", 2e-4, None, 2e-3, 5e-2))


BARS = {
    "convex": Bars(),  # tests/test_parity.py:120-150
    # delta / psi' to the cost resolution dilated by the terminal time
    # weight: median / p90 / max, no tight subset (test_parity_topt.py:95-141)
    "time_optimal": Bars(tight_rprim=None,
                         angles=(("delta", 2e-2, 1e-1, None, 5e-1),
                                 ("psi", 1e-2, 5e-2, None, 2.5e-1))),
    "real_seam": Bars(),  # tests/test_parity_real.py:95-113
}
# The convex step whose speed command no float32 solver of the repo holds to
# 1e-3: an obstacle pinch point (s = 4.104 m) whose QP is certified
# infeasible (violation floor 3.55e-3) and accepted under feas_tol = 5e-3.
# The fixed budget leaves its least-violation solution unconverged, so the
# speed command rides on rounding: on the same QP the port gives 0.848708,
# the JAX package's fused TPU kernel (interpret mode) 0.849761, its XLA
# solver 0.848369 and the port's structured solver 0.849047 (oracle 0.85);
# one ulp on one input moves the port's answer across 0.848577-0.852040,
# and the same algorithm in float64 gives 0.849604.
PINCH_STEP = 100
EXCEPTIONS = {"convex": PINCH_STEP}  # v printed, not held

# tests/test_parity_production.py:79-111: the lap done, its length within
# 15 % of the oracle's, accept >= 0.95, pose divergence from the oracle's
# free run <= 0.10 m over the first 10 steps and <= 0.25 m over 40
PROD_LAP_REL = 0.15
PROD_ACCEPT_MIN = 0.95
PROD_POSE = ((10, 0.10), (40, 0.25))
# tests/test_modes.py:21-52: time-optimal and tracking laps of T = 400 on
# Sim_Track (the preset's speed profile); the time-optimal lap no longer
# than the tracking one, its mean v > 0.85, max |e_y| < max(ub) + 0.05,
# neither lap failed
MODE_T = 400
MODE_V_MIN = 0.85
MODE_EY_MARGIN = 0.05


@contextlib.contextmanager
def one_thread():
    """Torch on one CPU thread inside the block.  The speed profile's dense
    float32 solve runs BLAS products whose blocking follows torch's thread
    count, so on the CPU the last bits of ``v_ref`` do too (117 of
    Sim_Track's 200 at 1 against 2 threads, <= 3e-7): a scenario built on
    one thread is the same, and its hash holds, whatever the caller's
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@one_thread()
def scenario(name: str = "convex", device="cpu") -> dict:
    """The JAX test's scenario (:data:`SCENARIOS`) from port objects:
    grid, path, configs, and ``s0`` (the oracle's start on the path)."""
    spec = SCENARIOS[name]
    preset = sim_track_preset if spec.track == "sim" else real_track_preset
    map_cfg, path_cfg, model, cfg, speed_cfg, obstacles = preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    # weights first, then the cranked solver (tests/test_parity_topt.py:47-49)
    if spec.time_optimal:
        cfg = time_optimal_config(cfg, t_weight=100.0, r_v=0.01, r_kappa=0.01)
    if spec.weights is not None or spec.solver is not None:
        cfg = dataclasses.replace(cfg, **(spec.weights or {}),
                                  **({} if spec.solver is None
                                     else dict(solver=spec.solver)))
    grid = load_grid_map(map_cfg, device=device)
    path = build_reference_path(grid, path_cfg)
    if obstacles:
        grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                                  obstacles)
    if spec.v_max is not None:
        speed_cfg = SpeedProfileConstraints(v_max=spec.v_max)
    path = compute_speed_profile(path, speed_cfg)
    s0 = 0.0 if spec.end_back is None else max(
        0.0, float(path.length) - spec.end_back)
    return dict(name=name, grid=grid, path=path, cfg=cfg, model=model, s0=s0,
                T=spec.T)


def oracle_inputs(sc: dict) -> dict:
    """What ``simulate_oracle`` reads, as float64 numpy, from a scenario
    built on the CPU."""
    # imported here: on the GPU image ``tests.oracle`` does not import, and
    # only the fixture's writer and its tests need the oracle
    from tests.oracle.sim import path_to_dict

    grid = sc["grid"]
    return dict(occ=grid.occ.cpu().numpy().astype(np.float64),
                origin=tuple(float(o) for o in grid.origin),
                res=float(grid.resolution), path=path_to_dict(sc["path"]))


def inputs_sha256(sc: dict) -> str:
    """sha256 of the oracle's inputs: the path arrays, the occupancy, the
    grid's placement, the configs, the run's T, K and S, and s0 where it is
    not 0."""
    ins = oracle_inputs(sc)
    h = hashlib.sha256()
    for key in sorted(ins["path"]):
        h.update(key.encode())
        h.update(np.ascontiguousarray(ins["path"][key], np.float64).tobytes())
    h.update(np.ascontiguousarray(ins["occ"]).tobytes())
    cfg = sc["cfg"]
    h.update(repr((ins["origin"], ins["res"], cfg, sc["model"], sc["T"],
                   cfg.n_scan_samples, cfg.max_segments)).encode())
    if sc["s0"]:
        h.update(repr(sc["s0"]).encode())
    return h.hexdigest()


def load_fixture(sc: dict) -> dict:
    """The scenario's fixture, checked against the oracle's inputs now."""
    path = fixture(sc["name"])
    regen = f"regenerate with tools/oracle_lap.py --scenario {sc['name']}"
    assert os.path.exists(path), regen
    data = dict(np.load(path))
    assert str(data["inputs_sha256"]) == inputs_sha256(sc), (
        f"the oracle's inputs changed: {regen}")
    return data


def run_oracle(sc: dict, progress=None) -> dict:
    """The oracle's run as the fixture's arrays."""
    from tests.oracle.sim import simulate_oracle

    ins = oracle_inputs(sc)
    cfg = sc["cfg"]
    olog = simulate_oracle(ins["occ"], ins["origin"], ins["res"], ins["path"],
                           cfg, sc["model"], sc["T"], K=cfg.n_scan_samples,
                           S=cfg.max_segments, qp_solver="ip",
                           progress=progress, s0=sc["s0"])
    pre = olog["pre"]
    out = {k: np.asarray(olog[k]) for k in LOGS}
    for i, key in enumerate(("pre_x", "pre_y", "pre_psi", "pre_s")):
        out[key] = np.asarray([p[i] for p in pre], np.float64)
    out["pre_u"] = np.stack([p[4] for p in pre]).astype(np.float64)
    out["pre_ic"] = np.asarray([p[5] for p in pre], np.int32)
    return out


def check_window(sc: dict, lap) -> None:
    """The oracle window the JAX test asserts: at least ``min_steps``
    steps, and on Real_Track's seam a run that reaches the path end."""
    spec = SCENARIOS[sc["name"]]
    steps = len(lap["x"])
    assert steps >= spec.min_steps, (
        f"{sc['name']}: oracle window {steps} steps < {spec.min_steps}")
    if spec.end_back is not None:
        assert lap["s"][-1] >= float(sc["path"].length), (
            f"{sc['name']}: the oracle run must reach the path end")


def port_step(sc: dict, lap, stage_solver: Optional[str] = None) -> dict:
    """One step of the port's public fleet step from every pre-step state
    of the oracle's run, as one fleet (lanes = oracle steps), each lane
    from ``init_fleet``'s fresh solver carry: ``v``, ``delta`` and the next
    pose ``x``, ``y``, ``psi``, ``s``, acceptance ``ok`` and ``r_prim``,
    float64 numpy (T,) each.  Runs on the scenario's device: kernels K2
    and K1 on the card, their plain versions on the CPU; ``stage_solver``
    replaces the config's (``"cr"``: K1-CR)."""
    from multi_purpose_mpc_tpu_torch.simulation import (
        init_fleet, simulate_fleet, static_horizon_table)

    grid, path, cfg, model = sc["grid"], sc["path"], sc["cfg"], sc["model"]
    if stage_solver is not None:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, stage_solver=stage_solver))
    dev = path.x.device
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    Bsz = len(lap["pre_x"])
    state = dataclasses.replace(
        init_fleet(path, cfg.N, Bsz), x=f32(lap["pre_x"]),
        y=f32(lap["pre_y"]), psi=f32(lap["pre_psi"]), s=f32(lap["pre_s"]),
        u_seq=f32(np.asarray(lap["pre_u"]).reshape(Bsz, -1)),
        infeasibility_count=torch.as_tensor(np.asarray(lap["pre_ic"]),
                                            dtype=torch.int32, device=dev))
    log = simulate_fleet(grid, path, cfg, model, SimConfig(max_steps=1),
                         state, table=static_horizon_table(grid, path, cfg,
                                                           model)).log
    return {k: getattr(log, k)[0].cpu().numpy().astype(
        bool if k == "ok" else np.float64)
        for k in ("v", "delta", "x", "y", "psi", "s", "ok", "r_prim")}


def parity(port: dict, lap, name: str = "convex") -> dict:
    """The numbers the scenario's JAX test holds to its bars (:data:`BARS`),
    from the port's step (:func:`port_step`) and the oracle's run.  ``v_max``
    is over every step both accept but the scenario's exception
    (:data:`EXCEPTIONS`); ``v_pinch`` is that step's difference."""
    bars = BARS[name]
    solved = np.asarray(lap["solved"], bool)
    both = port["ok"] & solved
    diff = {k: np.abs(port[k] - np.asarray(lap[k], np.float64))
            for k in ("v", "x", "y", "s", "delta", "psi")}
    out = dict(steps=len(solved), disagree=np.flatnonzero(port["ok"] != solved),
               both=float(both.mean()))
    rest = both.copy()
    if name in EXCEPTIONS:
        step = EXCEPTIONS[name]
        rest[step] = False
        out.update(v_pinch=float(diff["v"][step]),
                   v_pinch_port=float(port["v"][step]))
    tight = None
    if bars.tight_rprim is not None:
        tight = both & (port["r_prim"] < bars.tight_rprim)
        out["tight"] = int(tight.sum())
    for k in ("v", "x", "y", "s"):
        mask = rest if k == "v" else both
        d = diff[k][mask]
        out[f"{k}_max"], out[f"{k}_argmax"] = float(d.max()), int(
            np.flatnonzero(mask)[d.argmax()])
    for k, _, _, _, _ in bars.angles:
        d = diff[k][both]
        out[f"{k}_median"] = float(np.median(d))
        out[f"{k}_p90"] = float(np.percentile(d, 90))
        out[f"{k}_max"] = float(d.max())
        if tight is not None:
            out[f"{k}_tight_max"] = float(diff[k][tight].max())
    return out


def misses(par: dict, name: str = "convex") -> list:
    """Every bar of :data:`BARS` [name] that ``par`` (:func:`parity`)
    misses, as text; empty when all hold."""
    bars = BARS[name]
    out = [f"acceptance disagrees at steps {par['disagree'].tolist()}"
           ] if par["disagree"].size else []
    if par["both"] <= bars.both_min:
        out.append(f"both accept {par['both']:.4f} <= {bars.both_min}")
    if bars.tight_rprim is not None and \
            par["tight"] < bars.tight_min * par["steps"]:
        out.append(f"only {par['tight']}/{par['steps']} tight steps")
    out += [f"{k}: max |diff| {par[f'{k}_max']:.3e} > {bars.traj} at step "
            f"{par[f'{k}_argmax']}" for k in ("x", "y", "s", "v")
            if par[f"{k}_max"] > bars.traj]
    for k, b_med, b_p90, b_tight, b_all in bars.angles:
        for stat, bar in (("median", b_med), ("p90", b_p90),
                          ("tight_max", b_tight), ("max", b_all)):
            if bar is not None and par[f"{k}_{stat}"] > bar:
                out.append(f"{k} {stat} {par[f'{k}_{stat}']:.3e} > {bar}")
    return out


def describe(par: dict) -> str:
    """One line of :func:`parity`'s numbers."""
    head = (f"{par['steps']} steps, acceptance disagrees at "
            f"{par['disagree'].tolist()}, both accept {par['both']:.4f}"
            + (f", tight {par['tight']}" if "tight" in par else ""))
    traj = ", ".join(f"{k}' {par[f'{k}_max']:.3e}" for k in ("x", "y", "s"))
    ang = "; ".join(
        f"{k} " + " ".join(f"{st} {par[f'{k}_{st}']:.2e}"
                           for st in ("median", "p90", "tight_max", "max")
                           if f"{k}_{st}" in par)
        for k in ("delta", "psi"))
    pinch = (f"; v at exception step {par['v_pinch_port']:.6f}, |diff| "
             f"{par['v_pinch']:.3e} (not held)" if "v_pinch" in par else "")
    return (f"{head}; max|diff| {traj}, v {par['v_max']:.3e} (step "
            f"{par['v_argmax']}){pinch}; {ang}")


def free_run(res, lap) -> dict:
    """tests/test_parity_production.py:64-111's numbers from a port lap
    (a single-car :class:`~.simulation.SimResult`, (T,) logs) and the
    oracle's free run: ``done``, ``steps`` (active), ``oracle_steps``,
    ``accept`` over the active steps and ``pose_{k}``, the largest pose
    distance over the first k steps."""
    log = res.log
    active = log.active.cpu().numpy()
    n_active = int(active.sum())
    To = len(lap["x"])
    n_cmp = min(To, n_active)
    fx, fy = (getattr(log, k).cpu().numpy().astype(np.float64)
              for k in ("x", "y"))
    derr = np.hypot(fx[:n_cmp] - lap["x"][:n_cmp],
                    fy[:n_cmp] - lap["y"][:n_cmp])
    out = dict(done=bool(res.final_state.done.all()),
               steps=n_active, oracle_steps=To,
               accept=float(log.ok.cpu().numpy()[active].mean()))
    for k, _ in PROD_POSE:
        out[f"pose_{k}"] = float(derr[:k].max())
    return out


def free_run_misses(fr: dict) -> list:
    """The bars of tests/test_parity_production.py that ``fr`` misses."""
    out = [] if fr["done"] else ["the production lap did not complete"]
    if abs(fr["steps"] - fr["oracle_steps"]) > PROD_LAP_REL * fr["oracle_steps"]:
        out.append(f"lap length {fr['steps']} vs oracle {fr['oracle_steps']} "
                   f"outside {PROD_LAP_REL:.0%}")
    if fr["accept"] < PROD_ACCEPT_MIN:
        out.append(f"accept rate {fr['accept']:.3f} < {PROD_ACCEPT_MIN}")
    out += [f"pose divergence {fr[f'pose_{k}']:.4f} m > {bar} over {k} steps"
            for k, bar in PROD_POSE if fr[f"pose_{k}"] > bar]
    return out


@one_thread()
def mode_scenario(device="cpu") -> dict:
    """tests/test_modes.py's world (tests/conftest.py's ``sim_track`` with
    the preset's speed profile) and its two configs."""
    map_cfg, path_cfg, model, cfg, speed_cfg, obstacles = sim_track_preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    grid = load_grid_map(map_cfg, device=device)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed_cfg)
    return dict(grid=grid, path=path, model=model, tracking=cfg,
                time_optimal=time_optimal_config(cfg))


def mode_laps(ms: dict) -> dict:
    """The tracking and time-optimal laps of tests/test_modes.py (T =
    :data:`MODE_T`, ``simulate_closed_loop`` on ``ms``'s world) and their
    numbers."""
    from multi_purpose_mpc_tpu_torch.simulation import simulate_closed_loop

    length = float(ms["path"].length)
    out = {}
    for mode in ("tracking", "time_optimal"):
        res = simulate_closed_loop(ms["grid"], ms["path"], ms[mode],
                                   ms["model"], SimConfig(max_steps=MODE_T))
        s = res.log.s.cpu().numpy()
        act = res.log.active.cpu().numpy()
        out[mode] = dict(
            done=bool(res.final_state.done.all()),
            failed=bool(res.final_state.failed.any()),
            lap=int(np.argmax(s >= length)),
            v_mean=float(res.log.v.cpu().numpy()[act].mean()),
            max_ey=float(np.abs(res.log.e_y.cpu().numpy()[act]).max()))
    out["ey_bar"] = float(ms["path"].ub.max()) + MODE_EY_MARGIN
    return out


def mode_misses(m: dict) -> list:
    """The bars of tests/test_modes.py that ``m`` (:func:`mode_laps`)
    misses."""
    tr, to = m["tracking"], m["time_optimal"]
    out = [f"{k} lap incomplete" for k in ("tracking", "time_optimal")
           if not m[k]["done"]]
    if to["lap"] > tr["lap"]:
        out.append(f"time-optimal lap {to['lap']} > tracking {tr['lap']}")
    if to["v_mean"] <= MODE_V_MIN:
        out.append(f"time-optimal mean v {to['v_mean']:.4f} <= {MODE_V_MIN}")
    if to["max_ey"] >= m["ey_bar"]:
        out.append(f"time-optimal max |e_y| {to['max_ey']:.4f} >= "
                   f"{m['ey_bar']:.4f}")
    if to["failed"]:
        out.append("the time-optimal lap failed")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenario", default="convex", choices=sorted(SCENARIOS))
    ap.add_argument("--out", default=None,
                    help="default: the scenario's fixture in tests/data")
    args = ap.parse_args(argv)
    out = args.out or fixture(args.scenario)
    t0 = time.perf_counter()
    sc = scenario(args.scenario)
    digest = inputs_sha256(sc)
    lap = run_oracle(sc, progress=20)
    check_window(sc, lap)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, inputs_sha256=np.asarray(digest), **lap)
    print(f"oracle {args.scenario}: {len(lap['x'])} steps, accepted "
          f"{int(lap['solved'].sum())}, inputs sha256 {digest}, "
          f"{time.perf_counter() - t0:.1f} s -> {out}")


if __name__ == "__main__":
    main()
