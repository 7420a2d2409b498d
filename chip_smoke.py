"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Drives the port's paths — the Sim_Track obstacle-avoidance fleet on a
static and on a dynamic grid, per-lane weight sweeps, the escalation pass,
Real_Track and LiDAR in the loop; N = 30, S = 8, K = 128, the production
solver budget — through their public entry points, in phases:

1. device: requires CUDA; prints the card, CUDA version and power limit;
2. build: compiles the six CUDA kernels from
   ``multi_purpose_mpc_tpu_torch/csrc``, one nvcc per source, in parallel;
3. K2 (corridor selection) vs its plain twin on the horizon blocks of 4096
   feasible starts: bitwise, or fail above 1e-6;
4. K1 (fused QP assembly + ADMM + floor) vs its plain twin on 4096 lanes'
   first QP (their raw Monte-Carlo draw, before feasible_starts clips it,
   so some QPs are certified infeasible) and on the QP after 10 closed-loop
   steps: bitwise equal (W, Zw, Yeq, Yw, rho, r_prim, r_dual, floor; NaN
   equal to NaN), status agreement >= 99.5 %, r_prim within 1e-4, accepted
   U[:, 0] within 3e-3, floor within 1e-6, some floor > 0 in both; bitwise
   also at B = 1, at a ragged B = 33 and at N = 60 (B = 256); the kernel's
   time at B = 1, 128, 1024 and 4096 beside its bound ([K1 scaling]);
5. main path: ``simulate_fleet`` at B = 4096 for 50 steps; every kernel's
   launch count equals the step count; bench.py's fleet-health gates;
6. single car: ``simulate_closed_loop`` completes the lap within 250 steps
   with accept rate >= 0.9;
7. K4 (scanline extraction) vs its plain version, bitwise: the (4096, 30,
   128) horizon samples of the feasible starts on the shared grid, and a
   (256, 500, 500) per-lane grid stack with extra random disks;
8. K3 (ADMM on pre-assembled QPs) vs its plain version on 4096
   sweep-weighted QPs (first QP of the raw draw, and after 10 sweep
   steps), at K1's bars and bitwise, also at B = 1, 33 and N = 60; its
   scaling line ([K3 scaling]);
9. dynamic grid: ``simulate_fleet(static_grid=False)`` at B = 4096 for 50
   steps on the unchanged grid: K4 = K2 = K1 = 50 launches, K3 = 0, the
   log (x, y, v, ok, floor) bitwise equal to phase 5's, health gates;
10. sweep on the dynamic grid, B = 4096 x 50 steps, lanes tiling the
    reference, strictly convex and time-optimal weight rows: K4 = K2 = K3
    = 50, K1 = 0; accept per row; health gates (0 failed lanes included)
    over the reference lanes, at most 1 % failed lanes in the other rows;
11. escalation: static grid, B = 4096, ``escalate_lanes=128``, 20 steps:
    accept rate >= phase 5's over the same steps, and no lane accepted at
    step 0 without escalation is rejected with it;
12. Real_Track: B = 1024 x 30 steps from bench.py's starts: 0 failed
    lanes, solver-failure < 2 %;
13. K5 (map write-back + extraction) vs its plain version, bitwise: the
    phase-7 lane grids (256, and tiled to 4096) with 91 synthetic beams
    per lane, 60 % hits, a quarter of them on the lane's scanline samples;
14. K6 (the same on bit-packed maps) vs its plain version and vs K5,
    bitwise, on the (4096, 16, 500) packed grids; pad rows stay free;
15. LiDAR fleet, known map = true map, B = 4096 x 50 steps, bench.py's
    LiDAR, "auto" backends (cells scan, packed maps): K6 = K2 = K1 = 50
    launches, K4 = K5 = K3 = 0; the log bitwise equal to phase 9's; the
    maps stay the true grid; health gates; a CUDA-event step breakdown;
16. discovery fleet from an all-free known map, B = 1024 x 50 steps, packed
    then fused maps: cells found per lane, logs and final maps of the two
    runs bitwise equal, health gates; a step breakdown;
17. one car, ``simulate_lidar_loop``, 40 steps from an all-free known map:
    > 200 cells found, s > 1 m, not failed, max |e_y| < 0.25;
18. horizon N = 60, 30 steps: tests/test_horizon.py's three starts with
    its bars (every lane progresses > 0.5 m, no failed lane, accept > 0.8,
    max |e_y| < 0.25); then ``simulate_fleet`` at B = 1024 from
    ``feasible_starts``: K1 = K2 = 30 launches, bench.py's health gates,
    accept > 0.8, max |e_y| < 0.25, every lane that has not finished the
    lap progresses > 0.5 m.

Prints a JSON line with each kernel's launches, error, times and bound
(``bound_ms`` from the bytes each kernel must move and the float32
operations of its plain version, counted in this run, against the H100
SXM's 3.35 TB/s and 67 TFLOP/s), the card's name and power limit, and as
its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises (non-zero exit, no result line).  Imports no JAX.
"""

import dataclasses
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
# phases 4 and 8: the batches of the scaling lines and of the extra
# bitwise checks; phase 18's horizon fleet
SCALING_B = (1, 128, 1024, 4096)
BITWISE_B = (1, 33)
N60 = 60
N60_B = 256  # the N = 60 bitwise checks
N60_FLEET_B = 1024
N60_STEPS = 30
# phase 7-12 sizes
K4_LANE_GRIDS = 256
ESC_LANES = 128
ESC_STEPS = 20
RT_BATCH = 1024
RT_STEPS = 30
# phases 13-17: bench.py's LiDAR (360 deg, 1 m, 4 deg per beam: 91 beams,
# 192 samples per ray) and its batch for the discovery fleet
LIDAR_B = 1024
LOOP_STEPS = 40
# phase 16's bars, set from its first run on the card (0 failed lanes, max
# |e_y| 0.4344 m; PERF.md section 6).  From an all-free known map the exact
# corner-span scan marks corner-grazing cells at pinch points, corridors
# collapse and a lane replays its plan off the centre line: the JAX package
# drives the worst lane from the same start to 0.41 m with the cells scan
# and 0.05 m with the march scan (tools/jax_discovery_lanes.py)
DISC_FAILED_MAX = 0
DISC_MAX_EY = 0.50
# weight rows of phase 10 (Q | R | QN): reference tracking and strictly
# convex (tests/test_sweep.py), time-optimal (config.time_optimal_config)
SWEEP_ROWS = ("reference", "strictly_convex", "time_optimal")
# The reference row must lose no lane (bench.py's gate).  The other rows
# may lose a few at pinch points: at this seed the JAX package fails the
# same strictly convex lanes (their first QP ends just above feas_tol at
# the production budget, the replayed plan leaves the corridor), so the
# bar is a share of the row's lanes.
SWEEP_FAILED_MAX = 0.01


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


# the card's peaks for bound_ms (NVIDIA's H100 SXM data sheet): HBM3
# bandwidth and float32 outside the tensor cores, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# aten ops counted by count_ops: one operation per output element for the
# elementwise ones, per input element for the reductions
_ELEMENTWISE = frozenset("""abs add sub rsub mul div neg sqrt rsqrt reciprocal
    maximum minimum clamp clamp_min clamp_max where sign lt le gt ge eq ne
    logical_and logical_or logical_not logical_xor bitwise_and bitwise_or
    bitwise_xor bitwise_not bitwise_left_shift bitwise_right_shift
    __and__ __or__ __xor__ __lshift__ __rshift__ floor ceil trunc round exp
    log pow square sin cos atan2 hypot isfinite isnan isinf fmod remainder
    floor_divide addcmul addcdiv lerp copysign""".split())
_REDUCTIONS = frozenset("""sum mean amax amin max min prod cumsum cumprod any
    all argmax argmin""".split())


def count_ops(fn) -> int:
    """Arithmetic operations of ``fn()``, counted from the aten ops it
    dispatches (memory movement — copies, indexing, cat — counts none).
    Run on a kernel's plain version: each kernel repeats its plain version's
    arithmetic, operation for operation."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in _ELEMENTWISE:
                first = out[0] if isinstance(out, (tuple, list)) else out
                Counter.ops += first.numel()
            elif name in _REDUCTIONS:
                Counter.ops += args[0].numel()
            return out

    with Counter():
        fn()
    torch.cuda.synchronize()
    return Counter.ops


def nbytes(*objs) -> int:
    """Bytes of every distinct tensor in ``objs`` (through tuples, lists,
    named tuples and dataclasses): each input read once, each output
    written once."""
    seen, total = set(), 0

    def walk(o):
        nonlocal total
        if isinstance(o, torch.Tensor):
            key = (o.data_ptr(), o.numel(), o.dtype)
            if key not in seen:
                seen.add(key)
                total += o.numel() * o.element_size()
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)

    for o in objs:
        walk(o)
    return total


def bound(bytes_: int, ops: int):
    """``(bound_ms, bound_by)``: the least time the card could take, the
    larger of the bytes over the memory rate and the operations over the
    float32 rate."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lane_grids(grid, path, lanes: int, seed: int):
    """A (lanes, H, W) stack of the grid, each lane with 4 extra random
    disks (radius 1-4 cm) near random waypoints, drawn with numpy."""
    rng = np.random.default_rng(seed)
    wp = rng.integers(0, path.n_wp, (lanes, 4))
    off = rng.uniform(-0.08, 0.08, (lanes, 4, 2))
    rad = rng.uniform(0.01, 0.04, (lanes, 4))
    px, py = path.x.cpu().numpy()[wp], path.y.cpu().numpy()[wp]
    dev = grid.occ.device
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)[:, None, None]
    res, (ox, oy) = float(grid.resolution), grid.origin.tolist()
    xs = (torch.arange(grid.width, device=dev) + 0.5) * res + ox
    ys = (torch.arange(grid.height, device=dev) + 0.5) * res + oy
    occ = grid.occ.expand(lanes, -1, -1).clone()
    for d in range(4):
        cx, cy = t(px[:, d] + off[:, d, 0]), t(py[:, d] + off[:, d, 1])
        disk = ((xs[None, None, :] - cx) ** 2 + (ys[None, :, None] - cy) ** 2
                <= t(rad[:, d]) ** 2)
        occ[disk] = 0.0
    return occ


def health(log, final_state, path, model, steps, lanes=None):
    """bench.py's fleet-health numbers over ``lanes`` (all when None)."""
    if lanes is not None:
        log = type(log)(*(f[:, lanes] for f in log))
        final_state = dataclasses.replace(
            final_state, failed=final_state.failed[lanes])
    active = log.active
    if not bool(torch.isfinite(log.x).all() and torch.isfinite(log.v).all()):
        raise AssertionError("non-finite rollout")
    rej = ~log.ok & active
    n_act = max(int(active.sum()), 1)
    return dict(
        accept=float(log.ok[active].float().mean()),
        infeas=float((rej & (log.floor > 0)).sum()) / n_act,
        solver_fail=float((rej & (log.floor <= 0)).sum()) / n_act,
        failed=int(final_state.failed.sum()),
        progress=float((log.s[-1] - log.s[0]).mean()),
        exp_progress=0.5 * float(path.v_ref.mean()) * steps * model.Ts,
        max_ey=float(log.e_y[active].abs().max()))


def same_log(log, ref, label, fields=("x", "y", "v", "ok", "floor")):
    """Raise unless ``log`` equals ``ref`` bit for bit in ``fields`` (NaN
    equal to NaN)."""
    for f in fields:
        a, b = getattr(log, f), getattr(ref, f)
        diff = (a != b) & ~(torch.isnan(a.float()) & torch.isnan(b.float()))
        if diff.any():
            t, lane = (int(i) for i in diff.nonzero()[0])
            raise AssertionError(
                f"{label}: log.{f} differs, first at step {t}, lane {lane}: "
                f"{float(a[t, lane])} vs {float(b[t, lane])}")


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN equal to NaN: where several terms of a max
    reduction are NaN, K1/K3's warp reduction may return another NaN
    payload than a left-to-right maximum (csrc/admm_core.cuh)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = (a.view(torch.int32) == b.view(torch.int32)
            if a.dtype == torch.float32 else a == b)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


RAW_NAMES = ("W", "Zw", "Yeq", "Yw", "rho", "r_prim", "r_dual", "floor")


def first_lanes(obj, n):
    """The first ``n`` lanes (contiguous) of a tensor or of a dataclass of
    tensors (a carry, a StageQP); anything else (configs) as it is."""
    if isinstance(obj, torch.Tensor):
        return obj[:n].contiguous()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        vals = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
        if all(isinstance(v, torch.Tensor) for v in vals.values()):
            return type(obj)(**{k: v[:n].contiguous() for k, v in vals.items()})
    return obj


def profile_steps(label, run, steps: int, wall: float, card: str):
    """Device time by kernel over ``run()`` (a rollout of ``steps`` steps),
    from torch.profiler's CUDA activity, and the device's idle share
    against ``wall``, the ms per step of the same rollout unprofiled (the
    profiler slows the host's launches, not the device's work)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / steps
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:6]
    print(f"[profile] {label}, ms per step (torch.profiler, {card}): wall "
          f"{wall:.3f} unprofiled ({prof_wall:.3f} profiled), device busy "
          f"{busy:.3f}, idle "
          f"{100.0 * (1.0 - busy / wall):.1f} %; top: " + "; ".join(
              f"{e.key[:48]} {dev_us(e) / 1e3 / steps:.3f}" for e in top),
          flush=True)


def synthetic_hits(occ, px, py, nb: int, seed: int):
    """(hpx, hpy, hit), (B, nb) each: 60 % hits on random cells of the
    (B, H, W) grids, and a quarter of the beams on the lane's own scanline
    samples (px, py (B, N, K)), so that an extraction reading the grid
    before the write-back would differ."""
    Bsz, H, W = occ.shape
    gen = torch.Generator(device=occ.device).manual_seed(seed)
    r = lambda hi: torch.randint(0, hi, (Bsz, nb), generator=gen,
                                 device=occ.device, dtype=torch.int32)
    hpx, hpy = r(W), r(H)
    hit = torch.rand((Bsz, nb), generator=gen, device=occ.device) < 0.6
    on = nb // 4
    flat = torch.randint(0, px.shape[1] * px.shape[2], (Bsz, on),
                         generator=gen, device=occ.device)
    hpx[:, :on] = px.flatten(1).gather(1, flat)
    hpy[:, :on] = py.flatten(1).gather(1, flat)
    hit[:, :on] = True
    return hpx, hpy, hit


def check_health(h, label):
    if h["failed"] != 0 or h["solver_fail"] >= 0.02 \
            or h["progress"] <= h["exp_progress"] or h["max_ey"] >= 0.30:
        raise AssertionError(f"{label}: fleet health gates failed: {h}")


def fmt_health(h):
    return (f"accept {h['accept']:.4f}, certified-infeasible "
            f"{h['infeas']:.4f}, solver-failure {h['solver_fail']:.5f}, "
            f"failed lanes {h['failed']}, mean progress {h['progress']:.3f} m "
            f"(floor {h['exp_progress']:.3f}), max|e_y| {h['max_ey']:.4f}")


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

    from multi_purpose_mpc_tpu_torch.config import (
        LidarConfig, SimConfig, real_track_preset, sim_track_preset,
        time_optimal_config)
    from multi_purpose_mpc_tpu_torch.models.bicycle import init_car_state
    from multi_purpose_mpc_tpu_torch.mpc import (
        WeightSet, kappa_predictions, mpc_locate, mpc_pre_solve,
        mpc_step_batched_with_corridor)
    from multi_purpose_mpc_tpu_torch.ops import (admm_cuda, corridor_cuda,
                                                 corridor_extract, mapping)
    from multi_purpose_mpc_tpu_torch.ops.corridor_extract import horizon_segments
    from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
        build_horizon_table, empty_segments, gather_horizon_block,
        solver_inputs_from_block)
    from multi_purpose_mpc_tpu_torch.ops.lidar import hit_pixels, scan_fleet
    from multi_purpose_mpc_tpu_torch.ops.ltv_qp import pack_qp
    from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
    from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
    from multi_purpose_mpc_tpu_torch.simulation import (
        _locate_horizon, _post_control, _select_corridor_batched,
        feasible_starts, init_fleet, resolve_cell_table,
        simulate_closed_loop, simulate_fleet, simulate_lidar_fleet,
        simulate_lidar_loop, static_horizon_table)
    from multi_purpose_mpc_tpu_torch.utils import kernels
    from multi_purpose_mpc_tpu_torch.utils.maps import (
        add_obstacles_host, load_grid_map)

    # ---- phase 2: build ----
    names = ("corridor_select", "admm_fused", "admm_structured", "extract_occ",
             "writeback_extract", "writeback_extract_packed")
    t0 = time.perf_counter()
    for name, sec in kernels.build_all(names).items():
        kernels.load(name)
        print(f"[build] {name}.cu -> {kernels.library_path(name)} in "
              f"{sec:.2f} s", flush=True)
    print(f"[build] all six in {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    counted = {"admm_fused": admm_cuda.solve_mpc_qp_fused_cuda,
               "corridor_select": corridor_cuda.corridor_select_cuda,
               "admm_structured": admm_cuda.solve_ltv_qp_structured_cuda,
               "extract_occ": corridor_extract.extract_occ_cuda,
               "writeback_extract": mapping.writeback_extract_cuda,
               "writeback_extract_packed": mapping.writeback_extract_packed_cuda}

    def expect(**launches):
        """The launch counts of a path: the named kernels, 0 for the rest."""
        return {name: launches.get(name, 0) for name in counted}

    def reset_counts():
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in counted.items()}

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
    k2_bound = bound(nbytes(blk, ker), count_ops(
        lambda: corridor_cuda.corridor_select_plain(blk, S, sm)))
    print(f"[K2] bound {k2_bound[0]:.5f} ms ({k2_bound[1]})", flush=True)

    # ---- phase 4: K1 vs twin ----
    def k1_inputs(state, tbl=table, c=cfg):
        wp, e_y, e_psi = mpc_locate(state, path)
        b = gather_horizon_block(tbl, wp)
        cor = corridor_cuda.corridor_select_cuda(b, S, sm)
        v, k, ds = solver_inputs_from_block(b, S)
        x0 = torch.stack([e_y, e_psi, torch.zeros_like(e_y)], -1)
        return (v, k, ds, cor.lb, cor.ub, x0,
                kappa_predictions(state.u_seq, c.N), state.solver,
                c.solver, c, model)

    def bitwise_check(kernel, label, raw_k, raw_p):
        """Raise unless the kernel's raw outputs equal the plain version's
        bit for bit (NaN equal to NaN)."""
        bad = [n for n, a, b in zip(RAW_NAMES, raw_k, raw_p)
               if not same_bits(a, b)]
        print(f"[{kernel}] {label}: bitwise equal to the plain version on "
              f"{', '.join(RAW_NAMES[:len(raw_k)])}: {not bad}", flush=True)
        if bad:
            raise AssertionError(f"{kernel} differs from its plain version "
                                 f"({label}) in {bad}")

    def k1_check(label, args):
        raw_k = admm_cuda.solve_mpc_qp_fused_cuda(*args)
        raw_p = admm_cuda.solve_mpc_qp_fused_plain(*args)
        torch.cuda.synchronize()
        sol_k, fl_k = admm_cuda.finish(raw_k, args[0], args[1], args[3],
                                       args[4], cfg.solver, cfg)
        sol_p, fl_p = admm_cuda.finish(raw_p, args[0], args[1], args[3],
                                       args[4], cfg.solver, cfg)
        bitwise_check("K1", label, raw_k, raw_p)
        agree = float((sol_k.status == sol_p.status).float().mean())
        d_rp = float((sol_k.r_prim - sol_p.r_prim).abs().max())
        acc = ((sol_k.status != 2) & (sol_k.r_prim <= cfg.feas_tol)
               & (sol_p.status != 2) & (sol_p.r_prim <= cfg.feas_tol))
        d_u0 = float((sol_k.U[:, 0] - sol_p.U[:, 0]).abs()[acc].max())
        d_fl = float((fl_k - fl_p).abs().max())
        n_pos = int((fl_k > 0).sum())
        print(f"[K1] {label}: status agree {agree:.5f}, "
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
    # the N = 60 fleet of phase 18 and its first QPs
    cfg60 = dataclasses.replace(cfg, N=N60)
    table60 = static_horizon_table(grid, path, cfg60, model)
    wp60, ey60 = feasible_starts(grid, path, cfg60, model, N60_FLEET_B,
                                 np.random.default_rng(SEED))
    fleet60 = init_fleet(path, N60, N60_FLEET_B, e_y0=ey60, wp_id0=wp60)
    args60 = k1_inputs(fleet60, table60, cfg60)
    for label, args in [(f"B={n}, N={cfg.N}", [first_lanes(a, n)
                                               for a in args_first])
                        for n in BITWISE_B] + [
            (f"B={N60_B}, N={N60}", [first_lanes(a, N60_B) for a in args60])]:
        bitwise_check("K1", label, admm_cuda.solve_mpc_qp_fused_cuda(*args),
                      admm_cuda.solve_mpc_qp_fused_plain(*args))

    def scaling(kernel, launch, plain, args):
        """``{B: (ms, bound)}`` of ``launch(*first B lanes of args)``,
        printed as one line."""
        rows = {}
        for n in SCALING_B:
            a = [first_lanes(x, n) for x in args]
            rows[n] = (cuda_ms(lambda: launch(*a), 10),
                       bound(nbytes(a, launch(*a)),
                             count_ops(lambda: plain(*a))))
        print(f"[{kernel} scaling] N={cfg.N}, kernel ms (bound ms, by) per "
              f"batch: " + ", ".join(
                  f"B={n}: {ms:.4f} ({bnd[0]:.5f}, {bnd[1]})"
                  for n, (ms, bnd) in rows.items()) + f" ({card})", flush=True)
        return rows

    k1_rows = scaling("K1", admm_cuda.solve_mpc_qp_fused_cuda,
                      admm_cuda.solve_mpc_qp_fused_plain, args_first)
    k1_ms, k1_bound = k1_rows[B]
    k1_plain_ms = cuda_ms(lambda: admm_cuda.solve_mpc_qp_fused_plain(*args_first), 1)
    print(f"[K1] kernel {k1_ms:.3f} ms, twin {k1_plain_ms:.1f} ms, bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}) at B={B}, N={cfg.N} ({card})",
          flush=True)

    # ---- phase 5: main path ----
    reset_counts()
    t0 = time.perf_counter()
    res = simulate_fleet(grid, path, cfg, model, SimConfig(max_steps=STEPS),
                         fleet, table=table)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    print(f"[main] simulate_fleet B={B} x {STEPS} steps: launches {launches}",
          flush=True)
    if launches != expect(admm_fused=STEPS, corridor_select=STEPS):
        raise AssertionError(f"main path launches {launches}")
    static_log = res.log
    h = health(res.log, res.final_state, path, model, STEPS)
    print(f"[main] {B * STEPS / dt:.1f} car-steps/s ({dt:.3f} s wall), "
          f"{fmt_health(h)} on {card}", flush=True)
    check_health(h, "main")
    profile_steps(f"static grid B={B}", lambda: simulate_fleet(
        grid, path, cfg, model, SimConfig(max_steps=10), fleet, table=table),
        10, dt / STEPS * 1e3, card)

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

    # ---- phase 7: K4 vs plain ----
    scan = corridor_extract.build_scanline_table(grid, path, cfg.n_scan_samples)
    _, idx = _locate_horizon(fleet, path, cfg)
    hz = corridor_extract.horizon_tables(scan, idx)
    k4_err = 0.0
    lanes256 = lane_grids(grid, path, K4_LANE_GRIDS, SEED)
    for label, occ, px, py in (
            ("shared grid", grid.occ, hz.px, hz.py),
            ("per-lane grids", lanes256, hz.px[:K4_LANE_GRIDS].contiguous(),
             hz.py[:K4_LANE_GRIDS].contiguous())):
        ker = corridor_extract.extract_occ_cuda(occ, px, py)
        ref = corridor_extract.extract_occ_gather(occ, px, py)
        torch.cuda.synchronize()
        bitwise = torch.equal(ker, ref)
        err = float((ker - ref).abs().max())
        k4_err = max(k4_err, err)
        print(f"[K4] extract_occ vs plain, {label} {tuple(occ.shape)}, "
              f"samples {tuple(px.shape)}: bitwise={bitwise} "
              f"max|diff|={err:.3e}, free fraction {float(ker.mean()):.4f}",
              flush=True)
        if not bitwise:
            raise AssertionError(f"K4 differs from its plain version ({label})")
    k4_ms = cuda_ms(lambda: corridor_extract.extract_occ_cuda(
        grid.occ, hz.px, hz.py), 50)
    k4_plain_ms = cuda_ms(lambda: corridor_extract.extract_occ_gather(
        grid.occ, hz.px, hz.py), 50)
    k4_lib_ms = cuda_ms(lambda: grid.occ[hz.py, hz.px], 50)
    k4_bound = bound(nbytes(grid.occ, hz.px, hz.py) + 4 * hz.px.numel(),
                     count_ops(lambda: corridor_extract.extract_occ_gather(
                         grid.occ, hz.px, hz.py)))
    print(f"[K4] kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, one "
          f"indexing call occ[py, px] {k4_lib_ms:.4f} ms, bound "
          f"{k4_bound[0]:.4f} ms ({k4_bound[1]}) at {tuple(hz.px.shape)} on "
          f"the shared grid ({card})", flush=True)

    # ---- phase 8: K3 vs plain ----
    rows = {"reference": (cfg.Q, cfg.R, cfg.QN),
            "strictly_convex": ((1.0, 0.1, 0.0), (0.5, 0.01), (1.0, 0.1, 0.0))}
    topt = time_optimal_config(cfg)
    rows["time_optimal"] = (topt.Q, topt.R, topt.QN)
    row_of = torch.arange(B, device=dev) % len(SWEEP_ROWS)
    wsel = lambda i: torch.tensor([rows[r][i] for r in SWEEP_ROWS],
                                  dtype=torch.float32, device=dev)[row_of]
    weights = WeightSet(Q=wsel(0), R=wsel(1), QN=wsel(2))

    def k3_inputs(state, tbl=table, c=cfg, w=weights):
        located = mpc_locate(state, path)
        b = gather_horizon_block(tbl, located[0])
        cor = corridor_cuda.corridor_select_cuda(b, S, sm)
        qp, _ = mpc_pre_solve(state, c, model, located, cor,
                              solver_inputs_from_block(b, S), w)
        return pack_qp(qp), state.solver

    def k3_check(label, sq, warm):
        raw_k = admm_cuda.solve_ltv_qp_structured_cuda(sq, warm, cfg.solver)
        raw_p = admm_cuda.solve_ltv_qp_structured_plain(sq, warm, cfg.solver)
        torch.cuda.synchronize()
        qmax = sq.qv.abs().flatten(1).amax(1)
        sol_k = admm_cuda.finish_solve(raw_k, qmax, cfg.solver)
        sol_p = admm_cuda.finish_solve(raw_p, qmax, cfg.solver)
        bitwise_check("K3", label, raw_k, raw_p)
        agree = float((sol_k.status == sol_p.status).float().mean())
        d_rp = float((sol_k.r_prim - sol_p.r_prim).abs().max())
        acc = ((sol_k.status != 2) & (sol_k.r_prim <= cfg.feas_tol)
               & (sol_p.status != 2) & (sol_p.r_prim <= cfg.feas_tol))
        d_u0 = float((sol_k.U[:, 0] - sol_p.U[:, 0]).abs()[acc].max())
        print(f"[K3] {label}: status agree {agree:.5f}, "
              f"max|d r_prim| {d_rp:.3e}, max|d U0| (accepted, "
              f"{int(acc.sum())} lanes) {d_u0:.3e}", flush=True)
        if not (agree >= K1_STATUS_AGREE and d_rp <= K1_RPRIM_TOL
                and d_u0 <= K1_U0_TOL):
            raise AssertionError(f"K3 disagrees with its plain version ({label})")
        return max(d_rp, d_u0)

    sq_first, warm_first = k3_inputs(first)
    k3_err = k3_check("first QP, raw Monte-Carlo draw", sq_first, warm_first)
    swept10 = simulate_fleet(grid, path, cfg, model, SimConfig(max_steps=10),
                             fleet, table=table, weights=weights).final_state
    k3_err = max(k3_err, k3_check("QP after 10 sweep steps",
                                  *k3_inputs(swept10)))
    w60 = WeightSet(*(first_lanes(x, N60_B) for x in weights))
    sq60, warm60 = k3_inputs(init_fleet(path, N60, N60_B, e_y0=ey60[:N60_B],
                                        wp_id0=wp60[:N60_B]),
                             table60, cfg60, w60)
    for label, args in [(f"B={n}, N={cfg.N}",
                         (first_lanes(sq_first, n), first_lanes(warm_first, n)))
                        for n in BITWISE_B] + [
            (f"B={N60_B}, N={N60}", (sq60, warm60))]:
        bitwise_check("K3", label,
                      admm_cuda.solve_ltv_qp_structured_cuda(*args, cfg.solver),
                      admm_cuda.solve_ltv_qp_structured_plain(*args, cfg.solver))
    k3_rows = scaling("K3", lambda sq, w: admm_cuda.solve_ltv_qp_structured_cuda(
                          sq, w, cfg.solver),
                      lambda sq, w: admm_cuda.solve_ltv_qp_structured_plain(
                          sq, w, cfg.solver), (sq_first, warm_first))
    k3_ms, k3_bound = k3_rows[B]
    k3_plain_ms = cuda_ms(lambda: admm_cuda.solve_ltv_qp_structured_plain(
        sq_first, warm_first, cfg.solver), 1)
    print(f"[K3] kernel {k3_ms:.3f} ms, plain {k3_plain_ms:.1f} ms, bound "
          f"{k3_bound[0]:.4f} ms ({k3_bound[1]}) at B={B}, N={cfg.N} ({card})",
          flush=True)

    # ---- phase 9: dynamic grid ----
    dyn_sim = SimConfig(max_steps=STEPS, static_grid=False)
    reset_counts()
    t0 = time.perf_counter()
    dyn = simulate_fleet(grid, path, cfg, model, dyn_sim, fleet, table=scan)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dyn_launches = read_counts()
    print(f"[dynamic] simulate_fleet(static_grid=False) B={B} x {STEPS} "
          f"steps: launches {dyn_launches}", flush=True)
    if dyn_launches != expect(admm_fused=STEPS, corridor_select=STEPS,
                              extract_occ=STEPS):
        raise AssertionError(f"dynamic path launches {dyn_launches}")
    same_log(dyn.log, static_log, "dynamic grid vs static grid")
    h = health(dyn.log, dyn.final_state, path, model, STEPS)
    print(f"[dynamic] log (x, y, v, ok, floor) bitwise equal to the static "
          f"grid's; {B * STEPS / dt:.1f} car-steps/s ({dt:.3f} s wall), "
          f"{fmt_health(h)} on {card}", flush=True)
    check_health(h, "dynamic")

    # ---- phase 10: sweep on the dynamic grid ----
    reset_counts()
    t0 = time.perf_counter()
    sw = simulate_fleet(grid, path, cfg, model, dyn_sim, fleet, table=scan,
                        weights=weights)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sweep_launches = read_counts()
    print(f"[sweep] dynamic grid, WeightSet rows {SWEEP_ROWS} tiled over "
          f"B={B} x {STEPS} steps: launches {sweep_launches}", flush=True)
    if sweep_launches != expect(corridor_select=STEPS, admm_structured=STEPS,
                                extract_occ=STEPS):
        raise AssertionError(f"sweep path launches {sweep_launches}")
    for i, name in enumerate(SWEEP_ROWS):
        lanes = row_of == i
        act = sw.log.active[:, lanes]
        print(f"[sweep] {name}: accept "
              f"{float(sw.log.ok[:, lanes][act].float().mean()):.4f}, mean "
              f"progress {float((sw.log.s[-1] - sw.log.s[0])[lanes].mean()):.3f}"
              f" m, failed lanes {int(sw.final_state.failed[lanes].sum())}",
              flush=True)
    h = health(sw.log, sw.final_state, path, model, STEPS, lanes=row_of == 0)
    print(f"[sweep] {B * STEPS / dt:.1f} car-steps/s ({dt:.3f} s wall); "
          f"reference lanes: {fmt_health(h)} on {card}", flush=True)
    check_health(h, "sweep, reference lanes")
    for i, name in enumerate(SWEEP_ROWS[1:], 1):
        lanes = row_of == i
        if int(sw.final_state.failed[lanes].sum()) > SWEEP_FAILED_MAX \
                * int(lanes.sum()):
            raise AssertionError(f"sweep: failed lanes in row {name}")

    # ---- phase 11: escalation ----
    esc_cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, escalate_lanes=ESC_LANES))
    reset_counts()
    t0 = time.perf_counter()
    esc = simulate_fleet(grid, path, esc_cfg, model,
                         SimConfig(max_steps=ESC_STEPS), fleet, table=table)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    esc_launches = read_counts()
    off = type(static_log)(*(f[:ESC_STEPS] for f in static_log))
    acc_on = float(esc.log.ok[esc.log.active].float().mean())
    acc_off = float(off.ok[off.active].float().mean())
    flipped = int((~esc.log.ok[0] & off.ok[0]).sum())
    print(f"[escalation] static grid, escalate_lanes={ESC_LANES}, B={B} x "
          f"{ESC_STEPS} steps: launches {esc_launches}, accept {acc_on:.4f} "
          f"vs {acc_off:.4f} without, step-0 lanes accepted without and "
          f"rejected with: {flipped}; {B * ESC_STEPS / dt:.1f} car-steps/s "
          f"({dt:.3f} s wall)", flush=True)
    if esc_launches["admm_fused"] != 2 * ESC_STEPS:
        raise AssertionError(f"escalation launches {esc_launches}")
    if acc_on < acc_off or flipped:
        raise AssertionError("escalation lowered acceptance")

    # ---- phase 12: Real_Track ----
    t0 = time.perf_counter()
    rt_map, rt_path_cfg, rt_model, rt_cfg, rt_speed, _ = real_track_preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    rt_grid = load_grid_map(rt_map, device=dev)
    rt_path = compute_speed_profile(build_reference_path(rt_grid, rt_path_cfg),
                                    rt_speed)
    rng = np.random.default_rng(SEED)  # bench.py's draw (bench.py:198-204)
    rt_fleet = init_fleet(
        rt_path, rt_cfg.N, RT_BATCH,
        e_y0=torch.tensor(rng.uniform(-0.1, 0.1, RT_BATCH),
                          dtype=torch.float32, device=dev),
        wp_id0=torch.tensor(rng.integers(0, rt_path.n_wp // 2, RT_BATCH),
                            dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt = simulate_fleet(rt_grid, rt_path, rt_cfg, rt_model,
                        SimConfig(max_steps=RT_STEPS), rt_fleet)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    h = health(rt.log, rt.final_state, rt_path, rt_model, RT_STEPS)
    print(f"[real_track] {rt_grid.height}x{rt_grid.width} grid, "
          f"{rt_path.n_wp} waypoints (setup {t_setup:.2f} s), B={RT_BATCH} x "
          f"{RT_STEPS} steps: {RT_BATCH * RT_STEPS / dt:.1f} car-steps/s "
          f"({dt:.3f} s wall, table included), {fmt_health(h)} on {card}",
          flush=True)
    if h["failed"] != 0 or h["solver_fail"] >= 0.02:
        raise AssertionError("Real_Track health gates failed")

    # ---- phases 13-17: LiDAR in the loop ----
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    base = build_horizon_table(path, empty_segments(path.n_wp, S, dev), cfg)

    def breakdown(label, state, cells, step_ms):
        """CUDA-event times of the parts of one packed LiDAR step from
        ``state`` on the true map, against the rollout's wall per step."""
        pk = mapping.pack_rows(grid.occ).expand(state.batch, -1, -1).contiguous()
        parts = {}

        def part(name, fn, reps=3):
            parts[name] = cuda_ms(fn, reps)
            return fn()

        located, idx = part("locate", lambda: _locate_horizon(state, path, cfg))
        h = corridor_extract.horizon_tables(scan, idx)
        scans = part("scan (cells)", lambda: scan_fleet(
            grid, state.x, state.y, state.psi, lidar, cells=cells,
            wp_id=state.wp_id))
        hpx, hpy = hit_pixels(grid, scans, grid.height, grid.width)
        _, vals = part("K6", lambda: mapping.writeback_extract_packed_cuda(
            pk, hpx, hpy, scans.hit, h.px, h.py))
        segs = part("free runs", lambda: horizon_segments(vals, h, 2.0 * sm, S))
        corridor, blk = part("block + K2", lambda: _select_corridor_batched(
            base, located[0], segs, cfg, sm))
        out = part("solve (K1 + accept)", lambda: mpc_step_batched_with_corridor(
            state, cfg, model, located, corridor,
            solver_inputs_from_block(blk, S)), reps=1)
        part("plant + log", lambda: _post_control(out, path, model))
        rest = step_ms - sum(parts.values())
        print(f"[breakdown] LiDAR step at {label}, ms per step (CUDA events, "
              f"{card}): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f"; wall {step_ms:.3f}, rest (host gaps, idle) {rest:.3f}",
              flush=True)

    # ---- phase 13: K5 vs plain ----
    nb = lidar.n_beams
    px_all, py_all = hz.px, hz.py  # the fleet's (B, N, K) horizon samples
    stack = lanes256.repeat(B // K4_LANE_GRIDS, 1, 1)  # (B, H, W) lane grids
    hits = synthetic_hits(stack, px_all, py_all, nb, SEED)
    k56_err = 0.0

    def lanes_of(n):
        return [t[:n].contiguous() for t in (hits + (px_all, py_all))]

    for n in (K4_LANE_GRIDS, B):
        args = lanes_of(n)
        ker = mapping.writeback_extract_cuda(stack[:n], *args)
        ref = mapping.writeback_extract_plain(stack[:n], *args)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(ker, ref))
        stale = int((ker[1] != corridor_extract.extract_occ_gather(
            stack[:n], args[3], args[4])).sum())
        k56_err = max(k56_err, max(float((a - b).abs().max())
                                   for a, b in zip(ker, ref)))
        print(f"[K5] writeback_extract vs plain, ({n}, {grid.height}, "
              f"{grid.width}) lane grids, {nb} beams per lane: bitwise="
              f"{bitwise}; samples changed by the step's own hits: {stale}",
              flush=True)
        if not bitwise or stale == 0:
            raise AssertionError(f"K5 differs from its plain version ({n})")
    k5_times = {}
    for n in (K4_LANE_GRIDS, LIDAR_B, B):
        args = lanes_of(n)
        k5_times[n] = (
            cuda_ms(lambda: mapping.writeback_extract_cuda(stack[:n], *args), 20),
            cuda_ms(lambda: mapping.writeback_extract_plain(stack[:n], *args), 5))
    args = lanes_of(LIDAR_B)
    k5_bound = bound(
        nbytes(stack[:LIDAR_B], args,
               mapping.writeback_extract_cuda(stack[:LIDAR_B], *args)),
        count_ops(lambda: mapping.writeback_extract_plain(stack[:LIDAR_B],
                                                          *args)))
    k5_ms, k5_plain_ms = k5_times[LIDAR_B]
    print("[K5] " + ", ".join(f"B={n}: kernel {k:.4f} ms, plain {p:.4f} ms"
                              for n, (k, p) in k5_times.items())
          + f"; bound at B={LIDAR_B} {k5_bound[0]:.4f} ms ({k5_bound[1]}) "
          f"({card})", flush=True)

    # ---- phase 14: K6 vs plain and vs K5 ----
    packed = mapping.pack_rows(stack)
    args = lanes_of(B)
    ker6 = mapping.writeback_extract_packed_cuda(packed, *args)
    ref6 = mapping.writeback_extract_packed_plain(packed, *args)
    ker5 = mapping.writeback_extract_cuda(stack, *args)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(ker6, ref6))
    vs_k5 = (torch.equal(mapping.unpack_rows(ker6[0], grid.height), ker5[0])
             and torch.equal(ker6[1], ker5[1]))
    pad_free = bool((mapping.unpack_rows(ker6[0], packed.shape[1] * 32)
                     [:, grid.height:] == 1.0).all())
    k56_err = max(k56_err, float((ker6[1] - ref6[1]).abs().max()))
    print(f"[K6] writeback_extract_packed vs plain on {tuple(packed.shape)} "
          f"packed grids: bitwise={bitwise}; equal to K5={vs_k5}; pad rows "
          f"free={pad_free}", flush=True)
    if not (bitwise and vs_k5 and pad_free):
        raise AssertionError("K6 differs from its plain version or from K5")
    del ker5, ker6, ref6
    k6_times = {}
    for n in (LIDAR_B, B):
        a6 = lanes_of(n)
        pk = packed[:n].contiguous()
        k6_times[n] = (
            cuda_ms(lambda: mapping.writeback_extract_packed_cuda(pk, *a6), 50),
            cuda_ms(lambda: mapping.writeback_extract_packed_plain(pk, *a6), 3))
    k6_bound = bound(
        nbytes(packed, args,
               mapping.writeback_extract_packed_cuda(packed, *args)),
        count_ops(lambda: mapping.writeback_extract_packed_plain(packed,
                                                                 *args)))
    k6_ms, k6_plain_ms = k6_times[B]
    print("[K6] " + ", ".join(f"B={n}: kernel {k:.4f} ms, plain {p:.4f} ms"
                              for n, (k, p) in k6_times.items())
          + f"; bound at B={B} {k6_bound[0]:.4f} ms ({k6_bound[1]}) ({card})",
          flush=True)
    del stack, packed, args, hits
    torch.cuda.empty_cache()

    # ---- phase 15: LiDAR fleet, known map = true map ----
    t0 = time.perf_counter()
    cells = resolve_cell_table(grid, path, lidar, None, "cells")
    torch.cuda.synchronize()
    print(f"[lidar] cell table {tuple(cells.shape)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    lidar_kw = dict(table=scan, cells=cells)
    reset_counts()
    t0 = time.perf_counter()
    lres, locc = simulate_lidar_fleet(grid, grid, path, cfg, model, dyn_sim,
                                      lidar, fleet, **lidar_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lidar_launches = read_counts()
    print(f"[lidar] simulate_lidar_fleet known = true, B={B} x {STEPS} steps "
          f"(cells scan, packed maps): launches {lidar_launches}", flush=True)
    if lidar_launches != expect(admm_fused=STEPS, corridor_select=STEPS,
                                writeback_extract_packed=STEPS):
        raise AssertionError(f"LiDAR fleet launches {lidar_launches}")
    same_log(lres.log, dyn.log, "LiDAR fleet (known = true)")
    if not torch.equal(locc, grid.occ.expand_as(locc)):
        raise AssertionError("scans of the true world changed the true map")
    h = health(lres.log, lres.final_state, path, model, STEPS)
    print(f"[lidar] log (x, y, v, ok, floor) bitwise equal to the dynamic "
          f"grid's, maps unchanged; {B * STEPS / dt:.1f} car-steps/s "
          f"({dt:.3f} s wall), {fmt_health(h)} on {card}", flush=True)
    check_health(h, "LiDAR fleet")
    del lres, locc
    breakdown(f"B={B}", fleet, cells, dt / STEPS * 1e3)

    # ---- phase 16: discovery fleet from an all-free known map ----
    free = dataclasses.replace(grid, occ=torch.ones_like(grid.occ))
    fleet16 = init_fleet(path, cfg.N, LIDAR_B, e_y0=ey0[:LIDAR_B],
                         wp_id0=wp0[:LIDAR_B])
    disc, disc_launches, disc_ms = {}, {}, None
    for wb in ("packed", "fused"):
        reset_counts()
        t0 = time.perf_counter()
        disc[wb] = simulate_lidar_fleet(grid, free, path, cfg, model, dyn_sim,
                                        lidar, fleet16, writeback_backend=wb,
                                        **lidar_kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read_counts()
        kernel = "writeback_extract_packed" if wb == "packed" else "writeback_extract"
        if got != expect(admm_fused=STEPS, corridor_select=STEPS,
                         **{kernel: STEPS}):
            raise AssertionError(f"discovery fleet ({wb}) launches {got}")
        disc_launches[wb] = got
        disc_ms = disc_ms if wb == "fused" else dt / STEPS * 1e3
        res16, occ16 = disc[wb]
        found = (occ16 < 0.5).flatten(1).sum(1)
        h = health(res16.log, res16.final_state, path, model, STEPS)
        lane_ey = torch.where(res16.log.active, res16.log.e_y.abs(),
                              torch.zeros_like(res16.log.e_y)).amax(0)
        worst = int(lane_ey.argmax())
        print(f"[discovery] {wb} maps, B={LIDAR_B} x {STEPS} steps from an "
              f"all-free known map: launches {got}; cells found per lane min "
              f"{int(found.min())}, mean {float(found.float().mean()):.1f}; "
              f"{LIDAR_B * STEPS / dt:.1f} car-steps/s ({dt:.3f} s wall), "
              f"{fmt_health(h)}; lanes with max|e_y| >= 0.30: "
              f"{int((lane_ey >= 0.30).sum())}, worst lane {worst} (start "
              f"waypoint {int(wp0[worst])}, e_y0 {float(ey0[worst])!r}) on "
              f"{card}", flush=True)
        if h["solver_fail"] >= 0.02 or h["progress"] <= h["exp_progress"] \
                or h["failed"] > DISC_FAILED_MAX \
                or h["max_ey"] >= DISC_MAX_EY or int(found.min()) == 0:
            raise AssertionError(f"discovery fleet ({wb}) health gates: {h}")
    same_log(disc["fused"][0].log, disc["packed"][0].log,
             "discovery fleet, fused vs packed", disc["packed"][0].log._fields)
    if not torch.equal(disc["fused"][1], disc["packed"][1]):
        raise AssertionError("fused and packed discovery maps differ")
    print("[discovery] fused and packed runs: logs and final maps bitwise "
          "equal", flush=True)
    breakdown(f"B={LIDAR_B}", fleet16, cells, disc_ms)
    del disc

    # ---- phase 17: single car, LiDAR in the loop ----
    t0 = time.perf_counter()
    loop, known = simulate_lidar_loop(grid, free, path, cfg, model,
                                      SimConfig(max_steps=LOOP_STEPS), lidar,
                                      state0=init_car_state(path, cfg.N),
                                      table=scan)
    torch.cuda.synchronize()
    n_found = int((free.occ - known.occ).sum())
    s_end = float(loop.final_state.s[0])
    max_ey = float(loop.log.e_y.abs().max())
    failed = bool(loop.final_state.failed[0])
    print(f"[lidar loop] one car, {LOOP_STEPS} steps from an all-free known "
          f"map: {n_found} cells found, s {s_end:.3f} m, failed {failed}, "
          f"max|e_y| {max_ey:.4f}, {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    if n_found <= 200 or s_end <= 1.0 or failed or max_ey >= 0.25:
        raise AssertionError("single-car LiDAR loop gates failed")

    # ---- phase 18: horizon N = 60, static grid ----
    # tests/test_horizon.py's own three starts, 30 steps, on the card
    fleet3 = init_fleet(path, N60, 3, wp_id0=torch.tensor(
        [0, 70, 140], dtype=torch.int32, device=dev))
    three = simulate_fleet(grid, path, cfg60, model,
                           SimConfig(max_steps=N60_STEPS), fleet3,
                           table=table60)
    h3 = health(three.log, three.final_state, path, model, N60_STEPS)
    ds3 = three.final_state.s - fleet3.s
    print(f"[horizon] N={N60}, tests/test_horizon.py's starts (waypoints 0, "
          f"70, 140) x {N60_STEPS} steps: progress "
          f"{[round(float(d), 3) for d in ds3]} m, failed "
          f"{h3['failed']}, accept {h3['accept']:.4f}, max|e_y| "
          f"{h3['max_ey']:.4f}", flush=True)
    if not (bool((ds3 > 0.5).all()) and h3["failed"] == 0
            and h3["accept"] > 0.8 and h3["max_ey"] < 0.25):
        raise AssertionError(f"N = {N60}: tests/test_horizon.py's bars "
                             f"missed on the card: {h3}")
    reset_counts()
    t0 = time.perf_counter()
    res60 = simulate_fleet(grid, path, cfg60, model,
                           SimConfig(max_steps=N60_STEPS), fleet60,
                           table=table60)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n60_launches = read_counts()
    h = health(res60.log, res60.final_state, path, model, N60_STEPS)
    # a lane that finishes the lap stops (done): starts in the lap's last
    # metres progress less than 0.5 m, at N = 30 as at N = 60
    lane_prog = res60.final_state.s - fleet60.s
    done = res60.final_state.done
    moving = lane_prog[~done]
    print(f"[horizon] simulate_fleet N={N60}, B={N60_FLEET_B} x {N60_STEPS} "
          f"steps from feasible_starts: launches {n60_launches}; "
          f"{N60_FLEET_B * N60_STEPS / dt:.1f} car-steps/s ({dt:.3f} s wall), "
          f"{fmt_health(h)}; lanes done (lap finished) {int(done.sum())}, "
          f"least progress of the others {float(moving.min()):.4f} m on "
          f"{card}", flush=True)
    if n60_launches != expect(admm_fused=N60_STEPS, corridor_select=N60_STEPS):
        raise AssertionError(f"N = {N60} fleet launches {n60_launches}")
    check_health(h, f"N = {N60} fleet")
    if not (bool((moving > 0.5).all()) and h["accept"] > 0.8
            and h["max_ey"] < 0.25):
        raise AssertionError(f"N = {N60} fleet misses its bars: {h}")

    def row(name, replaces, launches, err, ms, plain_ms, bnd, library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"multi_purpose_mpc_tpu_torch/csrc/{name}.cu",
                "replaces": f"multi_purpose_mpc_tpu/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    # library_ms: one PyTorch call computing the same function exists only
    # for K4 (advanced indexing); none solves the QPs, selects corridors or
    # writes and reads a map in one call
    print(json.dumps({"kernels": [
        row("corridor_select", "ops/corridor_pallas.py:38",
            launches["corridor_select"], k2_err, k2_ms, k2_plain_ms, k2_bound),
        row("admm_fused", "ops/admm_pallas.py:271", launches["admm_fused"],
            k1_err, k1_ms, k1_plain_ms, k1_bound),
        row("admm_structured", "ops/admm_pallas.py:1001",
            sweep_launches["admm_structured"], k3_err, k3_ms, k3_plain_ms,
            k3_bound),
        row("extract_occ", "ops/corridor_extract.py:210",
            dyn_launches["extract_occ"], k4_err, k4_ms, k4_plain_ms, k4_bound,
            k4_lib_ms),
        row("writeback_extract", "ops/mapping_pallas.py:41",
            disc_launches["fused"]["writeback_extract"], k56_err, k5_ms,
            k5_plain_ms, k5_bound),
        row("writeback_extract_packed", "ops/mapping_pallas.py:169",
            lidar_launches["writeback_extract_packed"], k56_err, k6_ms,
            k6_plain_ms, k6_bound),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
