"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Drives the port's main path — the Sim_Track obstacle-avoidance fleet on a
static grid, N = 30, S = 8, K = 128, the production solver budget — through
its public entry points, in phases:

1. device: requires CUDA; prints the card, CUDA version and power limit;
2. build: compiles both CUDA kernels from ``multi_purpose_mpc_tpu_torch/csrc``;
3. K2 (corridor selection) vs its plain twin on the horizon blocks of 4096
   feasible starts: bitwise, or fail above 1e-6;
4. K1 (fused QP assembly + ADMM + floor) vs its plain twin on 4096 lanes'
   first QP (their raw Monte-Carlo draw, before feasible_starts clips it,
   so some QPs are certified infeasible) and on the QP after 10 closed-loop
   steps: status agreement >= 99.5 %, r_prim within 1e-4, accepted U[:, 0]
   within 3e-3, floor within 1e-6, some floor > 0 in both;
5. main path: ``simulate_fleet`` at B = 4096 for 50 steps; every kernel's
   launch count equals the step count; bench.py's fleet-health gates;
6. single car: ``simulate_closed_loop`` completes the lap within 250 steps
   with accept rate >= 0.9.

Prints a JSON line with each kernel's launches, error and times, the card's
name and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises (non-zero exit, no result line).  Imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
B = 4096
STEPS = 50
SEED = 20261016

# tolerances of phases 3-4 (the bars tests/test_admm_pallas.py holds the
# TPU kernels to)
K2_TOL = 1e-6
K1_STATUS_AGREE = 0.995
K1_RPRIM_TOL = 1e-4
K1_U0_TOL = 3e-3
K1_FLOOR_TOL = 1e-6


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    # ---- phase 1: device ----
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    print(f"[device] {kind}  torch {torch.__version__}  CUDA "
          f"{torch.version.cuda}  nvidia-smi: {card}", flush=True)

    from multi_purpose_mpc_tpu_torch.config import SimConfig, sim_track_preset
    from multi_purpose_mpc_tpu_torch.models.bicycle import init_car_state
    from multi_purpose_mpc_tpu_torch.mpc import kappa_predictions, mpc_locate
    from multi_purpose_mpc_tpu_torch.ops import admm_cuda, corridor_cuda
    from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
        gather_horizon_block, solver_inputs_from_block)
    from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
    from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
    from multi_purpose_mpc_tpu_torch.simulation import (
        feasible_starts, init_fleet, simulate_closed_loop, simulate_fleet,
        static_horizon_table)
    from multi_purpose_mpc_tpu_torch.utils import kernels
    from multi_purpose_mpc_tpu_torch.utils.maps import (
        add_obstacles_host, load_grid_map)

    # ---- phase 2: build ----
    for name in ("corridor_select", "admm_fused"):
        t0 = time.perf_counter()
        kernels.load(name)
        print(f"[build] {name}.cu -> {kernels.library_path(name)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- scenario ----
    t0 = time.perf_counter()
    map_cfg, path_cfg, model, cfg, speed_cfg, obstacles = sim_track_preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    grid = load_grid_map(map_cfg, device=dev)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution, obstacles)
    path = compute_speed_profile(path, speed_cfg)
    table = static_horizon_table(grid, path, cfg, model)
    wp0, ey0 = feasible_starts(grid, path, cfg, model, B,
                               np.random.default_rng(SEED))
    fleet = init_fleet(path, cfg.N, B, e_y0=ey0, wp_id0=wp0)
    torch.cuda.synchronize()
    print(f"[setup] Sim_Track {grid.height}x{grid.width} grid, {path.n_wp} "
          f"waypoints, table {tuple(table.shape)}, {B} feasible starts, "
          f"mean v_ref {float(path.v_ref.mean()):.4f}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    sm = model.safety_margin
    S = cfg.max_segments

    # ---- phase 3: K2 vs twin ----
    blk = gather_horizon_block(table, mpc_locate(fleet, path)[0])
    ker = corridor_cuda.corridor_select_cuda(blk, S, sm)
    ref = corridor_cuda.corridor_select_plain(blk, S, sm)
    torch.cuda.synchronize()
    k2_bitwise = all(torch.equal(a, b) for a, b in zip(ker, ref))
    k2_err = max(float((a - b).abs().max()) for a, b in zip(ker, ref))
    k2_ms = cuda_ms(lambda: corridor_cuda.corridor_select_cuda(blk, S, sm), 50)
    k2_plain_ms = cuda_ms(lambda: corridor_cuda.corridor_select_plain(blk, S, sm), 3)
    print(f"[K2] corridor_select vs twin on {tuple(blk.shape)} blocks: "
          f"bitwise={k2_bitwise} max|diff|={k2_err:.3e}; kernel {k2_ms:.4f} ms, "
          f"twin {k2_plain_ms:.3f} ms ({card})", flush=True)
    if k2_err > K2_TOL:
        raise AssertionError(f"K2 disagrees with its twin: {k2_err:.3e} > {K2_TOL}")

    # ---- phase 4: K1 vs twin ----
    def k1_inputs(state):
        wp, e_y, e_psi = mpc_locate(state, path)
        b = gather_horizon_block(table, wp)
        cor = corridor_cuda.corridor_select_cuda(b, S, sm)
        v, k, ds = solver_inputs_from_block(b, S)
        x0 = torch.stack([e_y, e_psi, torch.zeros_like(e_y)], -1)
        return (v, k, ds, cor.lb, cor.ub, x0,
                kappa_predictions(state.u_seq, cfg.N), state.solver,
                cfg.solver, cfg, model)

    def k1_check(label, args):
        raw_k = admm_cuda.solve_mpc_qp_fused_cuda(*args)
        raw_p = admm_cuda.solve_mpc_qp_fused_plain(*args)
        torch.cuda.synchronize()
        sol_k, fl_k = admm_cuda.finish(raw_k, args[0], args[1], args[3],
                                       args[4], cfg.solver, cfg)
        sol_p, fl_p = admm_cuda.finish(raw_p, args[0], args[1], args[3],
                                       args[4], cfg.solver, cfg)
        bitwise = all(torch.equal(a, b) for a, b in zip(raw_k, raw_p))
        agree = float((sol_k.status == sol_p.status).float().mean())
        d_rp = float((sol_k.r_prim - sol_p.r_prim).abs().max())
        acc = ((sol_k.status != 2) & (sol_k.r_prim <= cfg.feas_tol)
               & (sol_p.status != 2) & (sol_p.r_prim <= cfg.feas_tol))
        d_u0 = float((sol_k.U[:, 0] - sol_p.U[:, 0]).abs()[acc].max())
        d_fl = float((fl_k - fl_p).abs().max())
        n_pos = int((fl_k > 0).sum())
        print(f"[K1] {label}: bitwise={bitwise} status agree {agree:.5f}, "
              f"max|d r_prim| {d_rp:.3e}, max|d U0| (accepted, "
              f"{int(acc.sum())} lanes) {d_u0:.3e}, max|d floor| {d_fl:.3e}, "
              f"lanes with floor > 0: {n_pos}", flush=True)
        if not (agree >= K1_STATUS_AGREE and d_rp <= K1_RPRIM_TOL
                and d_u0 <= K1_U0_TOL and d_fl <= K1_FLOOR_TOL and n_pos > 0):
            raise AssertionError(f"K1 disagrees with its twin ({label})")
        return max(d_rp, d_u0, d_fl)

    rng = np.random.default_rng(SEED)  # the raw draw feasible_starts began from
    raw_wp = rng.integers(0, path.n_wp, B)
    raw_ey = rng.uniform(-0.03, 0.03, B)
    first = init_fleet(path, cfg.N, B,
                       e_y0=torch.tensor(raw_ey, dtype=torch.float32, device=dev),
                       wp_id0=torch.tensor(raw_wp, dtype=torch.int32, device=dev))
    args_first = k1_inputs(first)
    k1_err = k1_check("first QP, raw Monte-Carlo draw", args_first)
    warm = simulate_fleet(grid, path, cfg, model, SimConfig(max_steps=10),
                          fleet, table=table).final_state
    k1_err = max(k1_err, k1_check("QP after 10 closed-loop steps",
                                  k1_inputs(warm)))
    k1_ms = cuda_ms(lambda: admm_cuda.solve_mpc_qp_fused_cuda(*args_first), 3)
    k1_plain_ms = cuda_ms(lambda: admm_cuda.solve_mpc_qp_fused_plain(*args_first), 1)
    print(f"[K1] kernel {k1_ms:.3f} ms, twin {k1_plain_ms:.1f} ms at B={B}, "
          f"N={cfg.N} ({card})", flush=True)

    # ---- phase 5: main path ----
    for fn in (admm_cuda.solve_mpc_qp_fused_cuda,
               corridor_cuda.corridor_select_cuda):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate_fleet(grid, path, cfg, model, SimConfig(max_steps=STEPS),
                         fleet, table=table)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"admm_fused": admm_cuda.solve_mpc_qp_fused_cuda.launches,
                "corridor_select": corridor_cuda.corridor_select_cuda.launches}
    print(f"[main] simulate_fleet B={B} x {STEPS} steps: launches {launches}",
          flush=True)
    if any(n != STEPS for n in launches.values()):
        raise AssertionError(f"main path launches {launches} != {STEPS} steps")
    log = res.log
    active = log.active
    if not bool(torch.isfinite(log.x).all() and torch.isfinite(log.v).all()):
        raise AssertionError("non-finite rollout")
    accept = float(log.ok[active].float().mean())
    rej = ~log.ok & active
    n_act = max(int(active.sum()), 1)
    infeas = float((rej & (log.floor > 0)).sum()) / n_act
    solver_fail = float((rej & (log.floor <= 0)).sum()) / n_act
    failed = int(res.final_state.failed.sum())
    progress = float((log.s[-1] - log.s[0]).mean())
    exp_progress = 0.5 * float(path.v_ref.mean()) * STEPS * model.Ts
    max_ey = float(log.e_y[active].abs().max())
    rate = B * STEPS / dt
    print(f"[main] {rate:.1f} car-steps/s ({dt:.3f} s wall), accept "
          f"{accept:.4f}, certified-infeasible {infeas:.4f}, solver-failure "
          f"{solver_fail:.5f}, failed lanes {failed}, mean progress "
          f"{progress:.3f} m (floor {exp_progress:.3f}), max|e_y| "
          f"{max_ey:.4f} on {card}", flush=True)
    if failed != 0 or solver_fail >= 0.02 or progress <= exp_progress \
            or max_ey >= 0.30:
        raise AssertionError("fleet health gates failed")

    # ---- phase 6: single car ----
    t0 = time.perf_counter()
    lap = simulate_closed_loop(grid, path, cfg, model, SimConfig(max_steps=250),
                               state0=init_car_state(path, cfg.N), table=table)
    torch.cuda.synchronize()
    act = lap.log.active
    n_steps = int(act.sum())
    lap_accept = float(lap.log.ok[act].float().mean())
    done = bool(lap.final_state.done[0])
    print(f"[single] lap done={done} in {n_steps} active steps, accept "
          f"{lap_accept:.4f}, max|e_y| {float(lap.log.e_y[act].abs().max()):.4f}, "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    if not done or lap_accept < 0.9:
        raise AssertionError("single-car lap did not complete cleanly")

    print(json.dumps({"kernels": [
        {"name": "corridor_select", "route": "cuda",
         "source": "multi_purpose_mpc_tpu_torch/csrc/corridor_select.cu",
         "replaces": "multi_purpose_mpc_tpu/ops/corridor_pallas.py:38",
         "launches": launches["corridor_select"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "admm_fused", "route": "cuda",
         "source": "multi_purpose_mpc_tpu_torch/csrc/admm_fused.cu",
         "replaces": "multi_purpose_mpc_tpu/ops/admm_pallas.py:271",
         "launches": launches["admm_fused"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
