"""The float64 oracle's Sim_Track lap on the strictly convex scenario, as a
fixture for the port's 1e-3 trajectory test.

    python tools/oracle_lap.py [--out tests/data/torch_oracle_lap.npz]

Builds tests/test_parity.py's strictly convex scenario (Sim_Track with its
obstacles, Q = QN = (1, 0.1, 0), R = (0.5, 0.01), a 200 x 10 + 40 solver
budget, the speed profile at v_max = 0.85) from the port's own objects on
the CPU, runs ``tests.oracle.sim.simulate_oracle(..., qp_solver="ip")``
for T = 260 steps on the port's grid and path (~4 min), and writes the lap:

* ``pre_x``, ``pre_y``, ``pre_psi``, ``pre_s`` (T,), ``pre_u`` (T, N, 2),
  ``pre_ic`` (T,): the oracle's exact state before every step;
* ``x``, ``y``, ``psi``, ``v``, ``delta``, ``s``, ``solved`` (T,): its logs;
* ``inputs_sha256``: a hash of everything the oracle read (the path
  arrays, the occupancy grid, the configs, T, K, S).

``tests/test_torch_oracle.py`` rebuilds the scenario, compares the hash
and drives the port's fleet step from every pre-step state.  Imports
numpy, torch and the port; no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from multi_purpose_mpc_tpu_torch.config import (  # noqa: E402
    SolverConfig, SpeedProfileConstraints, sim_track_preset)
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops.speed_profile import (  # noqa: E402
    compute_speed_profile)
from multi_purpose_mpc_tpu_torch.utils.maps import (  # noqa: E402
    add_obstacles_host, load_grid_map)

FIXTURE = os.path.join(REPO, "tests", "data", "torch_oracle_lap.npz")
# tests/test_parity.py's lap: v_max 0.85 stretches it past 200 steps
T = 260
V_MAX = 0.85
LOGS = ("x", "y", "psi", "v", "delta", "s", "solved")


def scenario(device="cpu") -> dict:
    """tests/test_parity.py:67-84 from port objects: grid, path, configs."""
    map_cfg, path_cfg, model, cfg, _, obstacles = sim_track_preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    # the solver cranked well past its accept threshold, so the comparison
    # measures the math, not the iteration budget
    cfg = dataclasses.replace(
        cfg, Q=(1.0, 0.1, 0.0), QN=(1.0, 0.1, 0.0), R=(0.5, 0.01),
        solver=SolverConfig(iterations=200, rho_updates=10, polish_iters=40))
    grid = load_grid_map(map_cfg, device=device)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, SpeedProfileConstraints(v_max=V_MAX))
    return dict(grid=grid, path=path, cfg=cfg, model=model)


def oracle_inputs(sc: dict) -> dict:
    """What ``simulate_oracle`` reads, as float64 numpy, from a scenario
    built on the CPU."""
    # imported here: on the GPU image ``tests.oracle`` does not import, and
    # only the fixture's writer and its tests need the oracle
    from tests.oracle.sim import path_to_dict

    grid = sc["grid"]
    return dict(occ=grid.occ.numpy().astype(np.float64),
                origin=tuple(float(o) for o in grid.origin),
                res=float(grid.resolution), path=path_to_dict(sc["path"]))


def inputs_sha256(sc: dict) -> str:
    """sha256 of the oracle's inputs: the path arrays, the occupancy, the
    grid's placement, the configs and the lap's T, K and S."""
    ins = oracle_inputs(sc)
    h = hashlib.sha256()
    for key in sorted(ins["path"]):
        h.update(key.encode())
        h.update(np.ascontiguousarray(ins["path"][key], np.float64).tobytes())
    h.update(np.ascontiguousarray(ins["occ"]).tobytes())
    cfg = sc["cfg"]
    h.update(repr((ins["origin"], ins["res"], cfg, sc["model"], T,
                   cfg.n_scan_samples, cfg.max_segments)).encode())
    return h.hexdigest()


def run_oracle(sc: dict, progress=None) -> dict:
    """The oracle's lap as the fixture's arrays."""
    from tests.oracle.sim import simulate_oracle

    ins = oracle_inputs(sc)
    cfg = sc["cfg"]
    olog = simulate_oracle(ins["occ"], ins["origin"], ins["res"], ins["path"],
                           cfg, sc["model"], T, K=cfg.n_scan_samples,
                           S=cfg.max_segments, qp_solver="ip",
                           progress=progress)
    pre = olog["pre"]
    out = {k: np.asarray(olog[k]) for k in LOGS}
    for i, key in enumerate(("pre_x", "pre_y", "pre_psi", "pre_s")):
        out[key] = np.asarray([p[i] for p in pre], np.float64)
    out["pre_u"] = np.stack([p[4] for p in pre]).astype(np.float64)
    out["pre_ic"] = np.asarray([p[5] for p in pre], np.int32)
    return out


def port_step(sc: dict, lap) -> dict:
    """One step of the port's public fleet step from every pre-step state
    of the oracle's lap, as one fleet (lanes = oracle steps), each lane
    from ``init_fleet``'s fresh solver carry: ``v``, ``delta`` and the next
    pose ``x``, ``y``, ``psi``, ``s``, acceptance ``ok`` and ``r_prim``,
    float64 numpy (T,) each.  Runs on the scenario's device: kernels K2
    and K1 on the card, their plain versions on the CPU."""
    from multi_purpose_mpc_tpu_torch.config import SimConfig
    from multi_purpose_mpc_tpu_torch.simulation import (
        init_fleet, simulate_fleet, static_horizon_table)

    grid, path, cfg, model = sc["grid"], sc["path"], sc["cfg"], sc["model"]
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


# tests/test_parity.py:120-150's bars
TRAJ_BAR = 1e-3  # v, x', y', s' on every step both accept
BOTH_MIN = 0.9  # share of the lap both accept
TIGHT_RPRIM = 1e-4  # "tight": interior optimum, primal residual below this
TIGHT_MIN = 0.8  # share of the lap that is tight
MEDIAN_BAR = 2e-4  # delta, psi': median over the steps both accept
# (name, tight bar, bar on every step both accept)
ANGLE_BARS = (("delta", 5e-3, 1e-1), ("psi", 2e-3, 5e-2))
# The step whose speed command no float32 solver of the repo holds to 1e-3:
# an obstacle pinch point (s = 4.104 m) whose QP is certified infeasible
# (violation floor 3.55e-3) and accepted under feas_tol = 5e-3.  The fixed
# budget leaves its least-violation solution unconverged, so the speed
# command rides on rounding: on the same QP the port gives 0.848708, the
# JAX package's fused TPU kernel (interpret mode) 0.849761, its XLA solver
# 0.848369 and the port's structured solver 0.849047 (oracle 0.85); one ulp
# on one input moves the port's answer across 0.848577-0.852040, and the
# same algorithm in float64 gives 0.849604.
PINCH_STEP = 100


def parity(port: dict, lap) -> dict:
    """The numbers tests/test_parity.py:120-150 holds to its bars, from
    the port's step (:func:`port_step`) and the oracle's lap.  ``v_max`` is
    over every step both accept but :data:`PINCH_STEP`; ``v_pinch`` is that
    step's difference."""
    solved = np.asarray(lap["solved"], bool)
    both = port["ok"] & solved
    tight = both & (port["r_prim"] < TIGHT_RPRIM)
    diff = {k: np.abs(port[k] - np.asarray(lap[k], np.float64))
            for k in ("v", "x", "y", "s", "delta", "psi")}
    out = dict(steps=len(solved), disagree=np.flatnonzero(port["ok"] != solved),
               both=float(both.mean()), tight=int(tight.sum()),
               v_pinch=float(diff["v"][PINCH_STEP]),
               v_pinch_port=float(port["v"][PINCH_STEP]))
    rest = both.copy()
    rest[PINCH_STEP] = False
    for k in ("v", "x", "y", "s"):
        mask = rest if k == "v" else both
        d = diff[k][mask]
        out[f"{k}_max"], out[f"{k}_argmax"] = float(d.max()), int(
            np.flatnonzero(mask)[d.argmax()])
    for k, _, _ in ANGLE_BARS:
        out[f"{k}_median"] = float(np.median(diff[k][both]))
        out[f"{k}_tight_max"] = float(diff[k][tight].max())
        out[f"{k}_max"] = float(diff[k][both].max())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    sc = scenario()
    digest = inputs_sha256(sc)
    lap = run_oracle(sc, progress=20)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, inputs_sha256=np.asarray(digest), **lap)
    print(f"oracle lap: {len(lap['x'])} steps, accepted "
          f"{int(lap['solved'].sum())}, inputs sha256 {digest}, "
          f"{time.perf_counter() - t0:.1f} s -> {args.out}")


if __name__ == "__main__":
    main()
