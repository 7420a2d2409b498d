"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Drives the port's paths — the Sim_Track obstacle-avoidance fleet on a
static and on a dynamic grid, per-lane weight sweeps, the escalation pass,
Real_Track, LiDAR in the loop and the reference-mirroring object API;
N = 30, S = 8, K = 128, the production solver budget — through their
public entry points, in phases:

1. device: requires CUDA; prints the card, CUDA version and power limit;
2. build: compiles the six CUDA kernels from
   ``multi_purpose_mpc_tpu_torch/csrc``, one nvcc per source, in parallel;
3. K2 (corridor selection) vs its plain twin, bitwise (NaN equal to NaN)
   or fail: the horizon blocks of 4096 feasible starts, their first 1 and
   33, phase 18's N = 60 blocks, a dynamic-grid block (segments extracted
   from the grid) and a LiDAR block (segments from 256 lane maps after a
   hit write-back); the kernel's device time at B = 1, 128, 1024 and 4096
   beside its bound ([K2 scaling]);
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
    lanes, solver-failure < 2 %, max |e_y| over active lane-steps below
    max(path.ub) + 0.05 (tests/test_real_track.py's bar);
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
    lap progresses > 0.5 m;
19. the cyclic-reduction stage solver (``SolverConfig(stage_solver="cr")``):
    K1-CR and K3-CR bitwise equal to their CR plain versions (NaN equal to
    NaN) on phase 4's and phase 8's QPs at B = 4096, at B = 1 and 33, and
    at N = 31 and 60 (B = 256); CR against the Schur kernels on the
    B = 4096 QPs, the first and after 10 steps, at the bars of
    tests/test_torch_slice.py for two float32 solvers (acceptance
    agreement >= 95 %; the speed command U[:, 0, 0] within 1e-3 on >= 85 %
    of the lanes both accept, median <= 2e-4, max <= 1e-1; see CR_*
    below); ``[K1-CR scaling]`` and
    ``[K3-CR scaling]`` beside Schur's times, timed in turns; the CR fleet
    (static grid, B = 4096 x 50: K1-CR = K2 = 50 launches, bench.py's
    health gates, accept beside phase 5's); a CR sweep (static grid,
    B = 4096 x 20, phase 10's weight rows: K3-CR = K2 = 20 and phase 10's
    gates); an N = 60 CR fleet (B = 1024 x 30, phase 18's bars);
20. the float64 oracle's lap (``tests/data/torch_oracle_lap.npz``, written
    by ``tools/oracle_lap.py``): tests/test_parity.py's strictly convex
    scenario rebuilt on the card, all 204 oracle pre-step states as one
    fleet through one ``simulate_fleet`` step (K2 = K1 = 1 launch), held
    to tests/test_torch_oracle.py's bars (tests/test_parity.py:120-150);
    the speed command at ``oracle_lap.PINCH_STEP`` is printed, not held
    (the CPU test's strict xfail);
21. the reference's two-call loop through the object API (``api.Map``,
    ``ReferencePath`` + ``compute_speed_profile``, ``BicycleModel``,
    ``MPC``, ``LidarModel``, built as tests/test_api.py's world fixture
    builds them, on the preset's 9 obstacles): (a) the two-call loop
    ``u = mpc.get_control(); car.drive(u)`` on the static map until the
    lap is done, at most 300 steps; (b) the same loop with
    ``LidarModel.scan`` + ``update_map`` every step, from the true map, 60
    steps.  Each loop: per step K4 = K2 = K3 = 1 launch and no other
    kernel; the corridor of the first 5 steps bitwise equal to
    ``update_path_constraints`` through the plain versions on the card;
    accept >= 0.9, max |e_y| < 0.25 m, the infeasibility counter below
    N - 1 and (a) the lap done; (b) leaves the map as it was and repeats
    (a)'s controls bit for bit; the median and p99 wall ms per step of
    ``get_control``, ``drive`` and (b) ``scan`` + ``update_map``, and a
    torch.profiler split of ``get_control`` into kernel and other device
    time.

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

# tolerances of phase 4 (the bars tests/test_admm_pallas.py holds the TPU
# kernels to)
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
# phase 19: the CR sweep's steps and the horizon of 63 padded stages.  CR
# against the Schur kernels on the same B = 4096 QPs: two budget-limited
# float32 solvers that round differently part on unconverged pinch-point
# lanes (ROADMAP Queue 3: up to 3.8e-2 in v from operation order alone), so
# the bars are the repo's own for two such solvers on the same QPs
# (tests/test_torch_slice.py): acceptance agreement >= 95 %, and wherever
# both accept the speed command U[:, 0, 0] within 1e-3 on >= 85 % of the
# lanes, median <= 2e-4, max <= 1e-1.  The per-lane bars of the JAX
# package's CR tests at B = 8 (status equal, U[:, 0, 0] within 3e-3,
# tests/test_admm_pallas.py) are printed beside them as shares.
CR_SWEEP_STEPS = 20
CR_ACCEPT_AGREE = 0.95
CR_V = (1e-3, 0.85, 2e-4, 1e-1)  # tight bar, its share, median, band
CR_U0_TOL = 3e-3
N31 = 31
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


# an upper bound of the SM clock (the H100 SXM boosts to 1.98 GHz)
SPIN_HZ = 2e9


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, for
    kernels shorter than the host's per-call overhead (Python, ctypes and
    allocation, tens of microseconds), which :func:`cuda_ms` would time
    instead: a spin kernel holds the stream for twice the host's time to
    enqueue the calls, so the events bracket only the device's run."""
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2.0 * host_s * SPIN_HZ))
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


def bit_err(pairs) -> float:
    """Largest |a - b| over float32 tensor pairs (0 where the bits agree,
    NaN against NaN included; inf where one side alone is NaN)."""
    err = 0.0
    for a, b in pairs:
        same = (a.view(torch.int32) == b.view(torch.int32)) | (
            torch.isnan(a) & torch.isnan(b))
        d = torch.where(same, torch.zeros_like(a), (a - b).abs())
        err = max(err, float(d.nan_to_num(nan=float("inf")).max()))
    return err


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
    k2 = sum(dev_us(e) for e in events if "corridor_select" in e.key)
    print(f"[profile] {label}, ms per step (torch.profiler, {card}): wall "
          f"{wall:.3f} unprofiled ({prof_wall:.3f} profiled), device busy "
          f"{busy:.3f}, idle "
          f"{100.0 * (1.0 - busy / wall):.1f} %, K2 {k2 / 1e3 / steps:.4f}; "
          f"top: " + "; ".join(
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


API_LAP_STEPS = 300
API_LIDAR_STEPS = 60
API_CHECKED_STEPS = 5  # steps whose corridor is held against the plain path
API_PROFILE_STEPS = 20
API_MAX_EY = 0.25
API_ACCEPT = 0.9


def plain_corridor(grid, path, wp_id, N, min_width, sm, n_samples, S):
    """``constraints.update_path_constraints`` with the plain versions of
    K4 (``extract_occ_gather``) and K2 (``corridor_select_plain``) on the
    same (card) tensors and the same cached tables."""
    from multi_purpose_mpc_tpu_torch.ops import constraints as cons
    from multi_purpose_mpc_tpu_torch.ops.corridor_cuda import corridor_select_plain
    from multi_purpose_mpc_tpu_torch.ops.corridor_extract import (
        extract_occ_gather, horizon_segments, horizon_tables)
    from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
        horizon_block_from_segments)
    from multi_purpose_mpc_tpu_torch.ops.path import gather_waypoint_index

    scan, table = cons.corridor_tables(grid, path, N, n_samples, S)
    wp = wp_id.reshape(-1).long()
    idx = gather_waypoint_index(path, wp[:, None],
                                torch.arange(N, device=wp.device)[None, :])
    h = horizon_tables(scan, idx)
    segs = horizon_segments(extract_occ_gather(grid.occ, h.px, h.py), h,
                            min_width, S)
    blk = horizon_block_from_segments(table, gather_waypoint_index(path, wp, 0),
                                      segs)
    return corridor_select_plain(blk, S, sm)


def api_phase(map_cfg, path_cfg, model, cfg, speed_cfg, obstacles, card,
              reset_counts, read_counts, expect):
    """Phase 21 (module docstring): the two-call loop through the object
    API, on the static map and with the LiDAR writing into it."""
    from multi_purpose_mpc_tpu_torch import api

    def world():
        m = api.Map(map_cfg.file_path, map_cfg.origin, map_cfg.resolution,
                    device="cuda")
        rp = api.ReferencePath(m, path_cfg.wp_x, path_cfg.wp_y,
                               path_cfg.resolution, path_cfg.smoothing_distance,
                               path_cfg.max_width, path_cfg.circular)
        m.add_obstacles([api.Obstacle(*o) for o in obstacles])
        car = api.BicycleModel(rp, model.length, model.width, model.Ts)
        kmax = np.tan(cfg.delta_max) / car.length
        ctrl = api.MPC(car, cfg.N, np.diag(cfg.Q), np.diag(cfg.R),
                       np.diag(cfg.QN),
                       {"xmin": np.full(3, -np.inf), "xmax": np.full(3, np.inf)},
                       {"umin": np.array([cfg.v_min, -kmax]),
                        "umax": np.array([cfg.v_max, kmax])}, cfg.ay_max)
        rp.compute_speed_profile(speed_cfg)
        return m, rp, car, ctrl

    # the step's ControlOutput, for its corridor: a spy around the API's
    # mpc_step that changes nothing
    seen = []
    step_fn = api.mpc_step

    def spy(*args, **kw):
        out = step_fn(*args, **kw)
        seen.append(out)
        return out

    api.mpc_step = spy
    sm = model.safety_margin
    pct = lambda a, q: float(np.percentile(np.asarray(a) * 1e3, q))
    controls = {}
    try:
        for label, steps, lidar in (("static map", API_LAP_STEPS, None),
                                    ("LiDAR scan + update_map", API_LIDAR_STEPS,
                                     api.LidarModel(FoV=180, range=2.0,
                                                    resolution=2))):
            m, rp, car, ctrl = world()
            data0 = m.data.copy()
            N = ctrl.N
            controls[label] = []
            times = {"get_control": [], "drive": [], "scan + update_map": []}
            accept, eys, max_count, bad = [], [], 0, []
            t_loop = time.perf_counter()
            for k in range(steps):
                if lidar is not None:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lidar.scan(car, m)
                    lidar.update_map(car, m)
                    torch.cuda.synchronize()
                    times["scan + update_map"].append(time.perf_counter() - t0)
                reset_counts()
                t0 = time.perf_counter()
                u = ctrl.get_control()
                times["get_control"].append(time.perf_counter() - t0)
                counts = read_counts()
                if counts != expect(extract_occ=1, corridor_select=1,
                                    admm_structured=1):
                    bad.append((k, counts))
                out = seen.pop()
                if k < API_CHECKED_STEPS:
                    ref = plain_corridor(m.grid, rp.path_data,
                                         out.state.wp_id + 1, N, 2.0 * sm, sm,
                                         cfg.n_scan_samples, cfg.max_segments)
                    if not all(same_bits(a, b) for a, b in zip(out.corridor, ref)):
                        raise AssertionError(f"API {label}: step {k}'s corridor "
                                             "differs from the plain versions'")
                accept.append(ctrl.infeasibility_counter == 0)
                max_count = max(max_count, ctrl.infeasibility_counter)
                eys.append(float(out.state.e_y[0]))
                controls[label].append(u)
                t0 = time.perf_counter()
                car.drive(u)
                torch.cuda.synchronize()
                times["drive"].append(time.perf_counter() - t0)
                if car.s >= rp.length:
                    break
            wall = time.perf_counter() - t_loop
            n = len(accept)
            acc = float(np.mean(accept))
            max_ey = float(np.max(np.abs(eys)))
            done = car.s >= rp.length
            print(f"[api] {label}: {n} steps ({wall:.2f} s wall), lap done "
                  f"{done}, accept {acc:.4f}, max|e_y| {max_ey:.4f}, max "
                  f"infeasibility counter {max_count}, launches per step "
                  f"K4 = K2 = K3 = 1 on {n - len(bad)} of {n}; corridor of "
                  f"steps 0-{API_CHECKED_STEPS - 1} bitwise equal to the plain "
                  f"versions; wall ms per step median / p99: " + ", ".join(
                      f"{name} {pct(t, 50):.3f} / {pct(t, 99):.3f}"
                      for name, t in times.items() if t) + f" ({card})",
                  flush=True)
            if bad:
                raise AssertionError(f"API {label}: launch counts {bad[:3]}")
            if lidar is not None:
                # the scans of the true map write nothing new into it, so
                # the loop repeats the static one's first steps
                same = np.array_equal(np.stack(controls[label]), np.stack(
                    controls["static map"][:n]))
                print(f"[api] {label}: map unchanged "
                      f"{np.array_equal(m.data, data0)}, controls bitwise "
                      f"equal to the static map's first {n} steps: {same}",
                      flush=True)
                if not same or not np.array_equal(m.data, data0):
                    raise AssertionError(f"API {label} departs from the "
                                         "static map's loop")
            if acc < API_ACCEPT or max_ey >= API_MAX_EY or max_count >= N - 1 \
                    or (lidar is None and not done):
                raise AssertionError(f"API {label} misses its bars")

        # where get_control's time goes: torch.profiler over a fresh loop
        from torch.profiler import ProfilerActivity, profile

        m, rp, car, ctrl = world()
        for _ in range(3):  # warm-up
            car.drive(ctrl.get_control())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(API_PROFILE_STEPS):
                u = ctrl.get_control()
                car.drive(u)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3 / API_PROFILE_STEPS
        dev_us = lambda e: getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0))
        events = [e for e in prof.key_averages() if dev_us(e) > 0]
        per = lambda es: sum(dev_us(e) for e in es) / 1e3 / API_PROFILE_STEPS
        ours = ("extract_occ", "corridor_select", "admm_structured")
        kern = [e for e in events if any(k in e.key for k in ours)]
        other = [e for e in events if e not in kern]
        print(f"[api profile] get_control + drive, ms per step (torch.profiler,"
              f" {card}): wall {prof_ms:.3f} profiled; device: kernels K4 + K2 "
              f"+ K3 {per(kern):.3f} (" + ", ".join(
                  f"{e.key[:40]} {per([e]):.4f}" for e in kern) + f"), other "
              f"device time {per(other):.3f} over "
              f"{sum(e.count for e in other) / API_PROFILE_STEPS:.0f} device "
              f"events; idle {100.0 * (1.0 - per(events) / prof_ms):.1f} %",
              flush=True)
    finally:
        api.mpc_step = step_fn


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
        LidarConfig, SimConfig, SolverConfig, real_track_preset,
        sim_track_preset, time_optimal_config)
    from multi_purpose_mpc_tpu_torch.models.bicycle import init_car_state
    from multi_purpose_mpc_tpu_torch.mpc import (
        WeightSet, kappa_predictions, mpc_locate, mpc_pre_solve,
        mpc_step_batched_with_corridor)
    from multi_purpose_mpc_tpu_torch.ops import (admm_cuda, corridor_cuda,
                                                 corridor_extract, mapping)
    from multi_purpose_mpc_tpu_torch.ops.corridor_extract import horizon_segments
    from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
        build_horizon_table, empty_segments, gather_horizon_block,
        horizon_block_from_segments, solver_inputs_from_block)
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
    # each kernel's launch counter: (wrapper, attribute); K1 and K3 count
    # their Schur and their cyclic-reduction instantiations apart
    counted = {"admm_fused": (admm_cuda.solve_mpc_qp_fused_cuda, "launches"),
               "admm_fused_cr": (admm_cuda.solve_mpc_qp_fused_cuda,
                                 "launches_cr"),
               "corridor_select": (corridor_cuda.corridor_select_cuda,
                                   "launches"),
               "admm_structured": (admm_cuda.solve_ltv_qp_structured_cuda,
                                   "launches"),
               "admm_structured_cr": (admm_cuda.solve_ltv_qp_structured_cuda,
                                      "launches_cr"),
               "extract_occ": (corridor_extract.extract_occ_cuda, "launches"),
               "writeback_extract": (mapping.writeback_extract_cuda,
                                     "launches"),
               "writeback_extract_packed": (
                   mapping.writeback_extract_packed_cuda, "launches")}

    def expect(**launches):
        """The launch counts of a path: the named kernels, 0 for the rest."""
        return {name: launches.get(name, 0) for name in counted}

    def reset_counts():
        torch.cuda.synchronize()
        for fn, attr in counted.values():
            setattr(fn, attr, 0)

    def read_counts():
        torch.cuda.synchronize()
        return {name: getattr(fn, attr) for name, (fn, attr) in counted.items()}

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
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    # the N = 60 fleet of phase 18
    cfg60 = dataclasses.replace(cfg, N=N60)
    table60 = static_horizon_table(grid, path, cfg60, model)
    wp60, ey60 = feasible_starts(grid, path, cfg60, model, N60_FLEET_B,
                                 np.random.default_rng(SEED))
    fleet60 = init_fleet(path, N60, N60_FLEET_B, e_y0=ey60, wp_id0=wp60)
    # the dynamic grid's and the LiDAR fleet's tables (phases 3, 7, 13-17)
    scan = corridor_extract.build_scanline_table(grid, path, cfg.n_scan_samples)
    located0, idx0 = _locate_horizon(fleet, path, cfg)
    hz = corridor_extract.horizon_tables(scan, idx0)
    base = build_horizon_table(path, empty_segments(path.n_wp, S, dev), cfg)
    lanes256 = lane_grids(grid, path, K4_LANE_GRIDS, SEED)

    # ---- phase 3: K2 vs plain ----
    blk = gather_horizon_block(table, located0[0])
    dyn_blk = horizon_block_from_segments(base, located0[0], horizon_segments(
        corridor_extract.extract_occ_gather(grid.occ, hz.px, hz.py), hz,
        2.0 * sm, S))
    h256 = type(hz)(*(t[:K4_LANE_GRIDS].contiguous() for t in hz))
    hits256 = synthetic_hits(lanes256, h256.px, h256.py, lidar.n_beams, SEED)
    _, vals256 = mapping.writeback_extract_plain(lanes256, *hits256, h256.px,
                                                 h256.py)
    lid_blk = horizon_block_from_segments(
        base, located0[0][:K4_LANE_GRIDS],
        horizon_segments(vals256, h256, 2.0 * sm, S))
    k2_err = 0.0
    for label, b in (
            (f"feasible starts B={B}", blk),
            *((f"feasible starts B={n}", blk[:n]) for n in BITWISE_B),
            (f"N={N60}, B={N60_FLEET_B}",
             gather_horizon_block(table60, mpc_locate(fleet60, path)[0])),
            (f"dynamic grid B={B}", dyn_blk),
            (f"LiDAR lane maps B={K4_LANE_GRIDS}", lid_blk)):
        b = b.contiguous()
        ker = corridor_cuda.corridor_select_cuda(b, S, sm)
        ref = corridor_cuda.corridor_select_plain(b, S, sm)
        torch.cuda.synchronize()
        bitwise = all(same_bits(x, y) for x, y in zip(ker, ref))
        err = bit_err(zip(ker, ref))
        k2_err = max(k2_err, err)
        collapsed = float((ker.ub == ker.lb).float().mean())
        print(f"[K2] corridor_select vs plain, {label} {tuple(b.shape)}: "
              f"bitwise={bitwise} max|diff|={err:.3e}; collapsed stages "
              f"{collapsed:.4f}", flush=True)
        if not bitwise:
            raise AssertionError(f"K2 differs from its plain version ({label})")
    k2_rows = {}
    for n in SCALING_B:
        b = blk[:n].contiguous()
        k2_rows[n] = (device_ms(lambda: corridor_cuda.corridor_select_cuda(
            b, S, sm), 200), bound(nbytes(b, corridor_cuda.corridor_select_cuda(
                b, S, sm)), count_ops(lambda: corridor_cuda.corridor_select_plain(
                    b, S, sm))))
    print(f"[K2 scaling] N={cfg.N}, S={S}, kernel device ms (bound ms, by) "
          f"per batch: " + ", ".join(
              f"B={n}: {ms:.5f} ({bnd[0]:.5f}, {bnd[1]})"
              for n, (ms, bnd) in k2_rows.items()) + f" ({card})", flush=True)
    k2_ms, k2_bound = k2_rows[B]
    k2_plain_ms = cuda_ms(lambda: corridor_cuda.corridor_select_plain(blk, S, sm), 3)
    print(f"[K2] kernel {k2_ms:.5f} ms, plain {k2_plain_ms:.3f} ms, bound "
          f"{k2_bound[0]:.5f} ms ({k2_bound[1]}) at B={B}, N={cfg.N} ({card})",
          flush=True)

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
    # the first QPs of phase 18's N = 60 fleet
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
    k4_err = 0.0
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
    # tests/test_real_track.py:66: the car stays within the widest static
    # corridor plus 5 cm
    ey_bar = float(rt_path.ub.max()) + 0.05
    print(f"[real_track] max|e_y| {h['max_ey']:.4f} m against max(path.ub) + "
          f"0.05 = {ey_bar:.4f} m", flush=True)
    if h["failed"] != 0 or h["solver_fail"] >= 0.02 or h["max_ey"] >= ey_bar:
        raise AssertionError(f"Real_Track health gates failed: {h}")

    # ---- phases 13-17: LiDAR in the loop ----
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
    k5_bounds = {}
    for n in (LIDAR_B, B):
        args = lanes_of(n)
        k5_bounds[n] = bound(
            nbytes(stack[:n], args, mapping.writeback_extract_cuda(stack[:n],
                                                                   *args)),
            count_ops(lambda: mapping.writeback_extract_plain(stack[:n], *args)))
    k5_bound = k5_bounds[LIDAR_B]
    k5_ms, k5_plain_ms = k5_times[LIDAR_B]
    print("[K5] " + ", ".join(f"B={n}: kernel {k:.4f} ms, plain {p:.4f} ms"
                              for n, (k, p) in k5_times.items())
          + "; bound " + ", ".join(f"at B={n} {b[0]:.4f} ms ({b[1]})"
                                   for n, b in k5_bounds.items())
          + f" ({card})", flush=True)

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

    # ---- phase 19: the cyclic-reduction stage solver ----
    cr_solver = dataclasses.replace(cfg.solver, stage_solver="cr")
    cfg_cr = dataclasses.replace(cfg, solver=cr_solver)

    def cr_args(args):
        """The same inputs with the CR stage solver in their SolverConfig."""
        return [dataclasses.replace(a, stage_solver="cr")
                if isinstance(a, SolverConfig) else a for a in args]

    k1cr_err = k3cr_err = 0.0
    cfg31 = dataclasses.replace(cfg, N=N31)
    table31 = static_horizon_table(grid, path, cfg31, model)
    fleet31 = init_fleet(path, N31, N60_B, e_y0=ey0[:N60_B], wp_id0=wp0[:N60_B])
    # (label, inputs, whether CR is also held against Schur on them)
    k1_sets = [("first QP, raw Monte-Carlo draw, B=4096", args_first, True),
               ("QP after 10 closed-loop steps, B=4096", k1_inputs(warm),
                True)]
    k1_sets += [(f"B={n}, N={cfg.N}", [first_lanes(a, n) for a in args_first],
                 False) for n in BITWISE_B]
    k1_sets += [(f"B={N60_B}, N={N31}", k1_inputs(fleet31, table31, cfg31),
                 False),
                (f"B={N60_B}, N={N60}", [first_lanes(a, N60_B) for a in args60],
                 False)]
    w31 = WeightSet(*(first_lanes(x, N60_B) for x in weights))
    k3_sets = [("first QP, raw Monte-Carlo draw, B=4096",
                (sq_first, warm_first), True),
               ("QP after 10 sweep steps, B=4096", k3_inputs(swept10), True)]
    k3_sets += [(f"B={n}, N={cfg.N}", (first_lanes(sq_first, n),
                                       first_lanes(warm_first, n)), False)
                for n in BITWISE_B]
    k3_sets += [(f"B={N60_B}, N={N31}",
                 k3_inputs(fleet31, table31, cfg31, w31), False),
                (f"B={N60_B}, N={N60}", (sq60, warm60), False)]

    def cr_vs_schur(kernel, label, sol_cr, sol_s):
        """CR against Schur on the same QPs: status and acceptance
        agreement, the speed command where both accept (the curvature
        command is cost-flat at R = (0.5, 0): only printed); the bars of
        CR_* above."""
        tol = cfg.feas_tol
        agree = float((sol_cr.status == sol_s.status).float().mean())
        ok_cr = (sol_cr.status != 2) & (sol_cr.r_prim <= tol)
        ok_s = (sol_s.status != 2) & (sol_s.r_prim <= tol)
        acc_agree = float((ok_cr == ok_s).float().mean())
        acc = ok_cr & ok_s
        d = (sol_cr.U[:, 0] - sol_s.U[:, 0]).abs()[acc]
        d_v, d_k = d[:, 0], float(d[:, 1].max())
        v_max, v_med = float(d_v.max()), float(d_v.median())
        tight, share, med_bar, band = CR_V
        within = {x: float((d_v <= x).float().mean()) for x in (tight,
                                                               CR_U0_TOL)}
        print(f"[{kernel}] {label}: CR vs Schur kernel: status agree "
              f"{agree:.5f}, acceptance agree {acc_agree:.5f}; speed "
              f"U[:, 0, 0] over {int(acc.sum())} lanes both accept: max|d| "
              f"{v_max:.3e}, median {v_med:.3e}, share within {tight:g} "
              f"{within[tight]:.5f}, within {CR_U0_TOL:g} "
              f"{within[CR_U0_TOL]:.5f}; max|d U[:, 0, 1]| (curvature, "
              f"cost-flat) {d_k:.3e}", flush=True)
        if (acc_agree < CR_ACCEPT_AGREE or within[tight] < share
                or v_med > med_bar or v_max > band):
            raise AssertionError(f"{kernel} disagrees with Schur ({label})")

    for label, args, vs_schur in k1_sets:
        a = cr_args(args)
        raw_k = admm_cuda.solve_mpc_qp_fused_cuda(*a)
        raw_p = admm_cuda.solve_mpc_qp_fused_plain(*a)
        torch.cuda.synchronize()
        bitwise_check("K1-CR", label, raw_k, raw_p)
        k1cr_err = max(k1cr_err, bit_err(zip(raw_k, raw_p)))
        if vs_schur:
            fin = lambda raw, c: admm_cuda.finish(raw, a[0], a[1], a[3], a[4],
                                                  c, cfg)[0]
            cr_vs_schur("K1-CR", label, fin(raw_k, cr_solver),
                        fin(admm_cuda.solve_mpc_qp_fused_cuda(*args),
                            cfg.solver))
    for label, (sq, w), vs_schur in k3_sets:
        raw_k = admm_cuda.solve_ltv_qp_structured_cuda(sq, w, cr_solver)
        raw_p = admm_cuda.solve_ltv_qp_structured_plain(sq, w, cr_solver)
        torch.cuda.synchronize()
        bitwise_check("K3-CR", label, raw_k, raw_p)
        k3cr_err = max(k3cr_err, bit_err(zip(raw_k, raw_p)))
        if vs_schur:
            qmax = sq.qv.abs().flatten(1).amax(1)
            cr_vs_schur("K3-CR", label,
                        admm_cuda.finish_solve(raw_k, qmax, cr_solver),
                        admm_cuda.finish_solve(
                            admm_cuda.solve_ltv_qp_structured_cuda(
                                sq, w, cfg.solver), qmax, cfg.solver))

    def cr_scaling(kernel, launch, plain, args, schur_args):
        """``{B: (ms, bound)}`` of the CR kernel on the first B lanes of
        ``args``, timed in turns with the Schur kernel on ``schur_args``
        (CR, Schur, Schur, CR; each time the mean of its two), printed as
        one line."""
        rows, line = {}, []
        for n in SCALING_B:
            a = [first_lanes(x, n) for x in args]
            s_ = [first_lanes(x, n) for x in schur_args]
            t = [cuda_ms(lambda: launch(*x), 10) for x in (a, s_, s_, a)]
            cr_ms, schur_ms = 0.5 * (t[0] + t[3]), 0.5 * (t[1] + t[2])
            rows[n] = (cr_ms, bound(nbytes(a, launch(*a)),
                                    count_ops(lambda: plain(*a))))
            line.append(f"B={n}: {cr_ms:.4f} (Schur {schur_ms:.4f}; bound "
                        f"{rows[n][1][0]:.5f}, {rows[n][1][1]})")
        print(f"[{kernel} scaling] N={cfg.N}, kernel ms per batch: "
              + ", ".join(line) + f" ({card})", flush=True)
        return rows

    k1cr_rows = cr_scaling("K1-CR", admm_cuda.solve_mpc_qp_fused_cuda,
                           admm_cuda.solve_mpc_qp_fused_plain,
                           cr_args(args_first), args_first)
    k1cr_ms, k1cr_bound = k1cr_rows[B]
    k1cr_plain_ms = cuda_ms(lambda: admm_cuda.solve_mpc_qp_fused_plain(
        *cr_args(args_first)), 1)
    k3cr_rows = cr_scaling(
        "K3-CR", admm_cuda.solve_ltv_qp_structured_cuda,
        admm_cuda.solve_ltv_qp_structured_plain,
        (sq_first, warm_first, cr_solver), (sq_first, warm_first, cfg.solver))
    k3cr_ms, k3cr_bound = k3cr_rows[B]
    k3cr_plain_ms = cuda_ms(lambda: admm_cuda.solve_ltv_qp_structured_plain(
        sq_first, warm_first, cr_solver), 1)
    print(f"[K1-CR] kernel {k1cr_ms:.3f} ms, plain {k1cr_plain_ms:.1f} ms; "
          f"[K3-CR] kernel {k3cr_ms:.3f} ms, plain {k3cr_plain_ms:.1f} ms; "
          f"bound {k1cr_bound[0]:.4f} / {k3cr_bound[0]:.4f} ms at B={B}, "
          f"N={cfg.N} ({card})", flush=True)

    # the CR fleet: the main path with the CR stage solver
    reset_counts()
    t0 = time.perf_counter()
    cr_res = simulate_fleet(grid, path, cfg_cr, model,
                            SimConfig(max_steps=STEPS), fleet, table=table)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cr_launches = read_counts()
    print(f"[cr fleet] simulate_fleet stage_solver=cr, static grid, B={B} x "
          f"{STEPS} steps: launches {cr_launches}", flush=True)
    if cr_launches != expect(admm_fused_cr=STEPS, corridor_select=STEPS):
        raise AssertionError(f"CR fleet launches {cr_launches}")
    h_cr = health(cr_res.log, cr_res.final_state, path, model, STEPS)
    h_s = health(static_log, res.final_state, path, model, STEPS)
    print(f"[cr fleet] {B * STEPS / dt:.1f} car-steps/s ({dt:.3f} s wall), "
          f"{fmt_health(h_cr)}; Schur fleet (phase 5) accept "
          f"{h_s['accept']:.4f}, solver-failure {h_s['solver_fail']:.5f} on "
          f"{card}", flush=True)
    check_health(h_cr, "CR fleet")
    profile_steps(f"static grid, CR, B={B}", lambda: simulate_fleet(
        grid, path, cfg_cr, model, SimConfig(max_steps=10), fleet,
        table=table), 10, dt / STEPS * 1e3, card)
    del cr_res

    # the CR sweep: per-lane weights reach K3-CR
    reset_counts()
    t0 = time.perf_counter()
    crsw = simulate_fleet(grid, path, cfg_cr, model,
                          SimConfig(max_steps=CR_SWEEP_STEPS), fleet,
                          table=table, weights=weights)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    crsw_launches = read_counts()
    row_accept = []
    for i, name in enumerate(SWEEP_ROWS):
        lanes = row_of == i
        act = crsw.log.active[:, lanes]
        row_accept.append(
            f"{name} {float(crsw.log.ok[:, lanes][act].float().mean()):.4f}")
    print(f"[cr sweep] stage_solver=cr, static grid, WeightSet rows "
          f"{SWEEP_ROWS} tiled over B={B} x {CR_SWEEP_STEPS} steps: launches "
          f"{crsw_launches}; accept per row {', '.join(row_accept)}; "
          f"{B * CR_SWEEP_STEPS / dt:.1f} car-steps/s ({dt:.3f} s wall)",
          flush=True)
    if crsw_launches != expect(admm_structured_cr=CR_SWEEP_STEPS,
                               corridor_select=CR_SWEEP_STEPS):
        raise AssertionError(f"CR sweep launches {crsw_launches}")
    check_health(health(crsw.log, crsw.final_state, path, model,
                        CR_SWEEP_STEPS, lanes=row_of == 0),
                 "CR sweep, reference lanes")
    for i, name in enumerate(SWEEP_ROWS[1:], 1):
        lanes = row_of == i
        if int(crsw.final_state.failed[lanes].sum()) > SWEEP_FAILED_MAX \
                * int(lanes.sum()):
            raise AssertionError(f"CR sweep: failed lanes in row {name}")
    del crsw

    # the N = 60 CR fleet, phase 18's bars
    cfg60_cr = dataclasses.replace(cfg60, solver=cr_solver)
    reset_counts()
    t0 = time.perf_counter()
    cr60 = simulate_fleet(grid, path, cfg60_cr, model,
                          SimConfig(max_steps=N60_STEPS), fleet60,
                          table=table60)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n60cr_launches = read_counts()
    h = health(cr60.log, cr60.final_state, path, model, N60_STEPS)
    moving = (cr60.final_state.s - fleet60.s)[~cr60.final_state.done]
    print(f"[cr horizon] simulate_fleet stage_solver=cr, N={N60}, "
          f"B={N60_FLEET_B} x {N60_STEPS} steps: launches {n60cr_launches}; "
          f"{N60_FLEET_B * N60_STEPS / dt:.1f} car-steps/s ({dt:.3f} s wall), "
          f"{fmt_health(h)}; least progress of the lanes not done "
          f"{float(moving.min()):.4f} m on {card}", flush=True)
    if n60cr_launches != expect(admm_fused_cr=N60_STEPS,
                                corridor_select=N60_STEPS):
        raise AssertionError(f"N = {N60} CR fleet launches {n60cr_launches}")
    check_health(h, f"N = {N60} CR fleet")
    if not (bool((moving > 0.5).all()) and h["accept"] > 0.8
            and h["max_ey"] < 0.25):
        raise AssertionError(f"N = {N60} CR fleet misses its bars: {h}")

    # ---- phase 20: the float64 oracle's lap ----
    from tools import oracle_lap as ol

    t0 = time.perf_counter()
    osc = ol.scenario(dev)
    lap = dict(np.load(ol.FIXTURE))
    reset_counts()
    par = ol.parity(ol.port_step(osc, lap), lap)
    oracle_launches = read_counts()
    print(f"[oracle] {par['steps']} oracle pre-step states through one "
          f"simulate_fleet step: launches {oracle_launches}, "
          f"{time.perf_counter() - t0:.2f} s with the scenario; acceptance "
          f"disagrees at {par['disagree'].tolist()}, both accept "
          f"{par['both']:.4f}, tight {par['tight']}; max|diff| x' "
          f"{par['x_max']:.3e}, y' {par['y_max']:.3e}, s' {par['s_max']:.3e},"
          f" v {par['v_max']:.3e} (step {par['v_argmax']}); v at pinch step "
          f"{ol.PINCH_STEP} {par['v_pinch_port']:.6f}, |diff| "
          f"{par['v_pinch']:.3e} (not held); delta median "
          f"{par['delta_median']:.2e} tight {par['delta_tight_max']:.2e} all "
          f"{par['delta_max']:.2e}; psi' median {par['psi_median']:.2e} tight "
          f"{par['psi_tight_max']:.2e} all {par['psi_max']:.2e} on {card}",
          flush=True)
    if oracle_launches != expect(admm_fused=1, corridor_select=1):
        raise AssertionError(f"oracle phase launches {oracle_launches}")
    misses = [f"acceptance disagrees at {par['disagree'].tolist()}"
              ] if par["disagree"].size else []
    misses += [f"{k} {par[k]:.3e} > {ol.TRAJ_BAR}"
               for k in ("x_max", "y_max", "s_max", "v_max")
               if par[k] > ol.TRAJ_BAR]
    if par["both"] <= ol.BOTH_MIN or par["tight"] < ol.TIGHT_MIN * par["steps"]:
        misses.append(f"both {par['both']:.4f}, tight {par['tight']}")
    for name, b_tight, b_all in ol.ANGLE_BARS:
        for key, bar in ((f"{name}_median", ol.MEDIAN_BAR),
                         (f"{name}_tight_max", b_tight), (f"{name}_max", b_all)):
            if par[key] > bar:
                misses.append(f"{key} {par[key]:.3e} > {bar}")
    if misses:
        raise AssertionError(f"oracle lap bars missed on the card: {misses}")

    # ---- phase 21: the two-call loop through the object API ----
    api_phase(map_cfg, path_cfg, model, cfg, speed_cfg, obstacles, card,
              reset_counts, read_counts, expect)

    def row(name, replaces, launches, err, ms, plain_ms, bnd, library_ms=None,
            source=None):
        return {"name": name, "route": "cuda",
                "source": f"multi_purpose_mpc_tpu_torch/csrc/{source or name}.cu",
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
        row("admm_fused_cr", "ops/admm_pallas.py:509",
            cr_launches["admm_fused_cr"], k1cr_err, k1cr_ms, k1cr_plain_ms,
            k1cr_bound, source="admm_fused"),
        row("admm_structured_cr", "ops/admm_pallas.py:509",
            crsw_launches["admm_structured_cr"], k3cr_err, k3cr_ms,
            k3cr_plain_ms, k3cr_bound, source="admm_structured"),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
