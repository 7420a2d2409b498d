"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Drives the port's paths — the Sim_Track obstacle-avoidance fleet on a
static and on a dynamic grid, per-lane weight sweeps, the escalation pass,
Real_Track, LiDAR in the loop, the reference-mirroring object API and the
fleets sharded over torch.distributed ranks;
N = 30, S = 8, K = 128, the production solver budget — through their
public entry points, in phases.  On the card every rollout and the object
API's control step replay CUDA graphs (``utils/graphs.py``), cached per
step, configuration and shapes: a call's first run captures, a repeated
call with fresh inputs of the same shapes replays.  Phases 5-22 run
graphed; phase 23 holds each path's first and repeated calls against
the eager form.

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
5. main path: ``simulate_fleet`` at B = 4096 for 50 steps, then again
   on fresh inputs of the same shapes (other starts, a speed profile
   capped at 0.8 m/s, one more obstacle, so another table): the repeated
   call replays the first call's cached graphs; in each every kernel's
   launch count equals the step count and bench.py's fleet-health gates
   hold; the repeated call's rate is the headline, the first call's
   (capture included) and its replays' beside it; a profiled repeated
   10-step rollout, whose device trace holds each kernel once a step, as
   the wrappers' counters say;
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
    (static grid, B = 4096 x 50, first and repeated call as in phase 5:
    K1-CR = K2 = 50 launches, bench.py's health gates, accept beside phase
    5's); a CR sweep (static grid,
    B = 4096 x 20, phase 10's weight rows: K3-CR = K2 = 20 and phase 10's
    gates); an N = 60 CR fleet (B = 1024 x 30, phase 18's bars);
20. the float64 oracle in the JAX package's four oracle-held task modes
    (fixtures ``tests/data/torch_oracle_*.npz``, written by
    ``tools/oracle_lap.py --scenario ...``), each scenario rebuilt on the
    card: for ``convex`` (tests/test_parity.py), ``time_optimal``
    (tests/test_parity_topt.py) and ``real_seam`` (Real_Track's
    non-circular seam, tests/test_parity_real.py) every oracle pre-step
    state as one lane of one ``simulate_fleet`` step, through K2 + K1
    (K1 = K2 = 1 launch) and again through K2 + K1-CR (K1-CR = K2 = 1),
    held to the JAX test's bars (``oracle_lap.BARS``; the convex speed
    command at ``oracle_lap.PINCH_STEP`` is printed, not held: the CPU
    test's strict xfail); the production free run (T = 300, K1 = K2 = 300)
    against the oracle's at tests/test_parity_production.py's bars; the
    tracking and time-optimal laps of tests/test_modes.py (T = 400 each)
    at its bars; one ``[oracle]`` line per scenario and solver, one for
    the production run, a ``[modes]`` line;
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
    ``get_control``, ``drive`` and (b) ``scan`` + ``update_map``; ``drive``
    graphed against eager, 200 calls each in turns (``[api drive]``); and a
    torch.profiler split of ``get_control`` into kernel and other device
    time;
22. the scale-out path (``parallel/``), checkpoint / resume and the
    profiling helpers: (a) ``init_distributed`` over NCCL at world size 1
    (localhost coordinates), ``simulate_fleet_sharded`` on phase 5's fleet
    (B = 4096 x 50): K1 = K2 = 50 launches, the log bitwise equal to phase
    5's, ``fleet_metrics`` under the mesh equal to the unsharded ones (max
    |e_y| bit for bit, the means within 1e-6 relative); (b) two gloo ranks
    on the one card (NCCL takes one GPU a rank), started by file path
    (tests/torch_dist_worker.py) with a timeout, the kernels built by this
    process: phase 16's packed discovery fleet split over the ranks, each
    rank's log and final maps bitwise equal to the same lanes of phase 16's
    run (K6 = K2 = K1 = 50 a rank), and a shared-grid fleet with
    ``clear_free`` (B = 1024 x 50, dense write-back, the masks pooled by
    one all-reduce per mask class a step), both ranks' maps and logs
    bitwise equal to an unsharded run here (K4 = K2 = K1 = 50); (c) 25
    static steps, ``save_fleet_state``, ``load_fleet_state``, 25 steps
    (a repeated call: it captures nothing): the log bitwise equal to phase
    5's; (d) a ``[profiling]`` line:
    ``timeit`` of one static step beside CUDA events and phase 5's wall
    per step, ``scan_marginal_cost`` of K2 beside its ``[K2 scaling]``
    time;
23. CUDA graphs and their cache: each path of phases 5-22 (the static
    fleet, Schur and CR; the dynamic grid and its sweep; escalation;
    N = 60; Real_Track; the LiDAR fleet, known = true; the discovery
    fleet, packed and fused; the single-car lap and LiDAR loop; over NCCL
    at world size 1 the sharded static fleet and a shared-grid fleet whose
    mask all-reduce is captured), after ``graphs.clear_cache()``: its
    first call (two graphs captured) and a repeated call on fresh inputs
    of the same shapes (a new fleet; on the static and dynamic grids and
    Real_Track a new speed profile and one more obstacle too; other
    weights for the sweep), which captures nothing and grows the
    allocator's reserve by nothing, each against the eager form
    (``graphs.disable_capture()``) on its own inputs: logs, final states
    and maps bitwise equal, the same launches; first call, repeated call,
    eager and replay times, capture seconds and peak memory per path; the
    object API's lap and its LiDAR loop (``scan`` and ``drive`` replay
    graphs too): controls and measurements bitwise equal, with the median
    / p99 ms of ``get_control``, ``drive`` and ``scan`` both ways.

Prints a JSON line with each kernel's launches (its path's phase and
phase 22), error, times and bound
(``bound_ms`` from the bytes each kernel must move and the float32
operations of its plain version, counted in this run, against the H100
SXM's 3.35 TB/s and 67 TFLOP/s), the card's name and power limit, and as
its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises (non-zero exit, no result line).  Imports no JAX.
"""

import contextlib
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
# the CR fleet's first call (accept, solver-failure, failed lanes, max
# |e_y|) as the CR kernels of the earlier design gave it (PERF.md section
# 6): the redesigned kernels keep every bit, so these stay to the digit
CR_FLEET_BEFORE = ("0.9755", "0.01054", 0, "0.1432")
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
# phase 22: two gloo ranks on the one card (NCCL takes one GPU a rank), the
# seconds they may take together, and the split of the checkpointed run
SCALE_RANKS = 2
RANK_TIMEOUT = 600
CKPT_STEPS = 25
# the repeated calls' fresh inputs of the same shapes (phases 5, 19, 23):
# starts drawn from SEED + 1, a speed profile capped at REPEAT_V_MAX m/s
# and one more obstacle (radius REPEAT_R m) halfway between the centre
# line and the left border at waypoint REPEAT_WP (Real_Track: RT_REPEAT_*)
REPEAT_V_MAX = 0.8
REPEAT_WP, REPEAT_R = 60, 0.02
RT_REPEAT_WP, RT_REPEAT_R = 100, 0.1


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


def repeat_obstacle(centre, wp: int, radius: float):
    """``(x, y, radius)`` of an obstacle halfway between the centre line
    and the left border at waypoint ``wp`` of the path ``centre``."""
    x, y = float(centre.x[wp]), float(centre.y[wp])
    bx, by = (float(v) for v in centre.border_ub[wp])
    return (0.5 * (x + bx), 0.5 * (y + by), radius)


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


def graph_times(wall: float, caps, steps: int):
    """``(capture s, first step s, replay ms a step)`` of a rollout's
    ``wall`` seconds: ``caps`` from ``capture_seconds`` (each graph's
    warm-up and capture; a graphed rollout's first step is the warm-up).
    Without graphs the replay column is the eager step."""
    cap = sum(c for _, c in caps)
    first = sum(w for w, _ in caps)
    if not caps:
        return 0.0, 0.0, wall / steps * 1e3
    return cap, first, (wall - cap - first) / (steps - 1) * 1e3


def profile_steps(label, run, steps: int, whole_ms: float, replay_ms: float,
                  card: str, counted: dict):
    """Device time by kernel over ``run(True)`` (a rollout of ``steps``
    steps on fresh inputs, repeating ``run(False)``, which captures its
    graphs first), from torch.profiler's CUDA activity, and the device's
    idle share against the repeated call's ms per step (``whole_ms``) and
    the first call's replays (``replay_ms``) of the full-length rollout
    unprofiled (the profiler slows the host's launches, not the device's
    work).  ``counted``: ``{kernel symbol: wrapper counter}``; each
    kernel's launches in the device trace must equal ``steps`` and its
    wrapper's count, so that the counts a replay adds are measured once on
    the device."""
    from torch.profiler import ProfilerActivity, profile

    from multi_purpose_mpc_tpu_torch.utils import kernels
    from multi_purpose_mpc_tpu_torch.utils.profiling import capture_seconds

    run(False)
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            capture_seconds() as caps:
        t0 = time.perf_counter()
        run(True)
        torch.cuda.synchronize()
        prof_ms = graph_times(time.perf_counter() - t0, caps, steps)[2]
    if caps:
        raise AssertionError(f"[profile] {label}: the repeated call captured")
    after = kernels.launch_counts()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    traced = {sym: sum(e.count for e in events if sym in e.key)
              for sym in counted}
    wrapped = {sym: after[c] - before[c] for sym, c in counted.items()}
    if any(traced[k] != steps or wrapped[k] != steps for k in counted):
        raise AssertionError(f"[profile] {label}: kernels in the device "
                             f"trace {traced}, counted by the wrappers "
                             f"{wrapped}, for {steps} steps")
    busy = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:6]
    k2 = sum(dev_us(e) for e in events if "corridor_select" in e.key)
    print(f"[profile] {label}, ms per step (torch.profiler, {card}): "
          f"repeated call {whole_ms:.3f} unprofiled ({prof_ms:.3f} "
          f"profiled), first call's replays {replay_ms:.3f}, device busy "
          f"{busy:.3f}, idle {100.0 * (1.0 - busy / whole_ms):.1f} % of the "
          f"repeated call, {100.0 * (1.0 - busy / replay_ms):.1f} % of the "
          f"replays; "
          f"launches in the device trace {traced} ({steps} steps, equal to "
          f"the wrappers' counts); K2 {k2 / 1e3 / steps:.4f}; "
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
API_DRIVE_REPS = 100  # phase 21: drive's calls a form and turn
API_GRAPH_STEPS = 20  # phase 23: the lap's graphed controls held to eager
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


def api_world(map_cfg, path_cfg, model, cfg, speed_cfg, obstacles):
    """tests/test_api.py's fixture on the card: ``(map, path, car, mpc)``."""
    from multi_purpose_mpc_tpu_torch import api

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


def api_phase(map_cfg, path_cfg, model, cfg, speed_cfg, obstacles, card,
              reset_counts, read_counts, expect):
    """Phase 21 (module docstring): the two-call loop through the object
    API, on the static map and with the LiDAR writing into it."""
    from multi_purpose_mpc_tpu_torch import api

    world = lambda: api_world(map_cfg, path_cfg, model, cfg, speed_cfg,
                              obstacles)

    # the step's ControlOutput, for its corridor: a spy around the API's
    # mpc_step that changes nothing.  On the card get_control replays a
    # captured graph, and the capture's ControlOutput holds the graph's own
    # outputs, which every replay rewrites with that step's values; a call
    # that captures runs its step eagerly first (the warm-up), and that
    # run's output is the call's
    seen, captured = [], []
    step_fn = api.mpc_step

    def spy(*args, **kw):
        out = step_fn(*args, **kw)
        (captured if torch.cuda.is_current_stream_capturing()
         else seen)[:] = [out]
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
                seen.clear()
                t0 = time.perf_counter()
                u = ctrl.get_control()
                times["get_control"].append(time.perf_counter() - t0)
                counts = read_counts()
                if counts != expect(extract_occ=1, corridor_select=1,
                                    admm_structured=1):
                    bad.append((k, counts))
                out = (seen or captured)[-1]
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

        # drive graphed against eager, in turns on one car (the first
        # graphed call, which captures, apart)
        from multi_purpose_mpc_tpu_torch.utils import graphs

        m, rp, car, ctrl = world()
        u = ctrl.get_control()
        drive_ms = {"graphed": [], "eager": []}
        for form in ("graphed", "eager", "eager", "graphed"):
            with (graphs.disable_capture() if form == "eager"
                  else contextlib.nullcontext()):
                for _ in range(API_DRIVE_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    car.drive(u)
                    torch.cuda.synchronize()
                    drive_ms[form].append(time.perf_counter() - t0)
        first_drive = drive_ms["graphed"].pop(0) * 1e3
        print(f"[api drive] BicycleModel.drive, {2 * API_DRIVE_REPS} calls "
              f"a form in turns (graphed, eager, eager, graphed), wall ms "
              f"median / p99 synchronised: graphed "
              f"{pct(drive_ms['graphed'], 50):.4f} / "
              f"{pct(drive_ms['graphed'], 99):.4f} (the first call, which "
              f"captures, {first_drive:.3f}), eager "
              f"{pct(drive_ms['eager'], 50):.4f} / "
              f"{pct(drive_ms['eager'], 99):.4f} on {card}", flush=True)

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



def lanes_of(log, sl):
    """The lanes ``sl`` of a (T, B) log, on the host."""
    return type(log)(*(f[:, sl].cpu() for f in log))


def metrics_match(got, ref, label):
    """Raise unless two ``fleet_metrics`` results agree: max |e_y| bit for
    bit, the means within 1e-6 relative."""
    for k, r in ref.items():
        g, r = got[k].cpu(), r.cpu()
        ok = (torch.equal(g, r) if k == "max_abs_e_y"
              else bool((g - r).abs() <= 1e-6 * r.abs()))
        if not ok:
            raise AssertionError(f"{label}: fleet_metrics {k} {float(g)!r} "
                                 f"vs {float(r)!r}")


def scale_out_phase(s, card, reset_counts, read_counts, expect):
    """Phase 22 (module docstring): the sharded fleets over
    ``torch.distributed`` (NCCL at world size 1; two gloo ranks on the one
    card), checkpoint / resume and the profiling helpers.  Returns the
    phase's kernel launches, its ranks' included."""
    import tempfile

    import torch.distributed as dist

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_dist_worker import free_port, launch

    from multi_purpose_mpc_tpu_torch.config import SimConfig
    from multi_purpose_mpc_tpu_torch.ops.corridor_cuda import corridor_select_cuda
    from multi_purpose_mpc_tpu_torch.parallel.fleet import (
        gather_fleet, simulate_fleet_sharded)
    from multi_purpose_mpc_tpu_torch.parallel.mesh import (fleet_metrics,
                                                           global_fleet_mesh,
                                                           init_distributed)
    from multi_purpose_mpc_tpu_torch.simulation import (simulate_fleet,
                                                        simulate_lidar_fleet)
    from multi_purpose_mpc_tpu_torch.utils.checkpoint import (
        load_fleet_state, save_fleet_state)
    from multi_purpose_mpc_tpu_torch.utils.profiling import (
        capture_seconds, scan_marginal_cost, timeit)

    grid, path, cfg, model = s["grid"], s["path"], s["cfg"], s["model"]
    fleet, table, static_log = s["fleet"], s["table"], s["static_log"]
    total = expect()

    def count(got, want, label):
        if got != want:
            raise AssertionError(f"{label}: launches {got}")
        for k, v in got.items():
            total[k] += v
        return {k: v for k, v in got.items() if v}

    # (a) NCCL at world size 1: the sharded static fleet is the fleet
    if not init_distributed(f"localhost:{free_port()}", 1, 0, device="cuda"):
        raise AssertionError("init_distributed returned False with coordinates")
    try:
        if dist.get_backend() != dist.Backend.NCCL:
            raise AssertionError(f"backend {dist.get_backend()}, not NCCL")
        mesh = global_fleet_mesh()
        reset_counts()
        t0 = time.perf_counter()
        res = simulate_fleet_sharded(mesh, grid, path, cfg, model,
                                     SimConfig(max_steps=STEPS), fleet)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read_counts()
        metrics = fleet_metrics(res.log, path.length, mesh)
        res = gather_fleet(res, mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    got = count(got, expect(admm_fused=STEPS, corridor_select=STEPS), "(a)")
    same_log(res.log, static_log, "(a) sharded fleet vs phase 5", static_log._fields)
    metrics_match(metrics, fleet_metrics(static_log, path.length),
                  "(a) under the mesh vs unsharded")
    print(f"[scale-out] (a) simulate_fleet_sharded over NCCL at world size "
          f"1, B={B} x {STEPS} steps: launches {got}; log bitwise equal to "
          f"phase 5's; fleet_metrics under the mesh equal the unsharded "
          f"ones ({', '.join(f'{k} {float(v):.6f}' for k, v in metrics.items())}"
          f"); {B * STEPS / dt:.1f} car-steps/s ({dt:.3f} s wall, horizon "
          f"table built inside) on {card}", flush=True)

    # (b) two gloo ranks on the one card: the per-lane discovery fleet of
    # phase 16 and a shared-grid fleet, each split over the ranks
    free, fleet16, dyn_sim = s["free"], s["fleet16"], s["dyn_sim"]
    lidar_kw = dict(table=s["scan"], cells=s["cells"])
    nb = fleet16.batch
    reset_counts()
    t0 = time.perf_counter()
    shared_ref, shared_occ = simulate_lidar_fleet(
        grid, free, path, cfg, model, dyn_sim, s["lidar"], fleet16,
        shared_grid=True, clear_free=True, **lidar_kw)
    torch.cuda.synchronize()
    dt_shared = time.perf_counter() - t0
    count(read_counts(), expect(admm_fused=STEPS, corridor_select=STEPS,
                                extract_occ=STEPS), "(b) unsharded shared")
    spec = dict(device="cuda", grid=grid, path=path, cfg=cfg, model=model,
                lidar=s["lidar"], known=free, tasks=dict(
                    lanes=dict(kind="lidar", sim=dyn_sim, state=fleet16,
                               kw=lidar_kw),
                    shared=dict(kind="lidar", sim=dyn_sim, state=fleet16,
                                kw=dict(shared_grid=True, clear_free=True,
                                        **lidar_kw))))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = launch(spec, SCALE_RANKS, d, RANK_TIMEOUT)
        dt_ranks = time.perf_counter() - t0
    lane_ref, lane_occ = s["disc_packed"]
    for r, out in enumerate(ranks):
        sl = slice(*out["lanes"]["lanes"])
        count(out["lanes"]["launches"], expect(
            admm_fused=STEPS, corridor_select=STEPS,
            writeback_extract_packed=STEPS), f"(b) rank {r} per-lane")
        same_log(out["lanes"]["result"].log, lanes_of(lane_ref.log, sl),
                 f"(b) rank {r} per-lane vs phase 16", static_log._fields)
        if not torch.equal(out["lanes"]["occ"], lane_occ[sl].cpu()):
            raise AssertionError(f"(b) rank {r}: per-lane maps differ from "
                                 "phase 16's")
        count(out["shared"]["launches"], expect(
            admm_fused=STEPS, corridor_select=STEPS, extract_occ=STEPS),
            f"(b) rank {r} shared")
        same_log(out["shared"]["result"].log, lanes_of(shared_ref.log, sl),
                 f"(b) rank {r} shared vs unsharded", static_log._fields)
        if not torch.equal(out["shared"]["occ"], shared_occ.cpu()):
            raise AssertionError(f"(b) rank {r}: shared map differs from the "
                                 "unsharded one")
        metrics_match(out["lanes"]["metrics"],
                      fleet_metrics(lane_ref.log, path.length),
                      f"(b) rank {r} per-lane")
        metrics_match(out["shared"]["metrics"],
                      fleet_metrics(shared_ref.log, path.length),
                      f"(b) rank {r} shared")
    found = int((free.occ - shared_occ).sum())
    for task, label in (("lanes", "per-lane packed maps (K6)"),
                        ("shared", "shared map, clear_free (K4)")):
        rates = ", ".join(
            f"rank {r} {(nb // SCALE_RANKS) * STEPS / out[task]['seconds']:.1f}"
            for r, out in enumerate(ranks))
        print(f"[scale-out] (b) {SCALE_RANKS} gloo ranks on one card, "
              f"B={nb} x {STEPS} steps, {label}: each rank's log, final "
              f"maps and launches "
              f"{ {k: v for k, v in ranks[0][task]['launches'].items() if v} }"
              f" as the "
              f"unsharded run's lanes, bitwise; car-steps/s {rates} (each "
              f"rank's own rollout); unsharded shared run "
              f"{nb * STEPS / dt_shared:.1f}, {found} cells found; both "
              f"ranks {dt_ranks:.2f} s wall with their start-up, on {card}",
              flush=True)

    # (c) checkpoint / resume: 25 steps, save, load, 25 steps = phase 5
    reset_counts()
    t0 = time.perf_counter()
    first = simulate_fleet(grid, path, cfg, model,
                           SimConfig(max_steps=CKPT_STEPS), fleet, table=table)
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "fleet.npz")
        save_fleet_state(ck, first.final_state, step=CKPT_STEPS)
        state, step = load_fleet_state(ck, like=first.final_state)
    # the resumed call repeats the first one's key: it replays its graphs
    with capture_seconds() as caps:
        rest = simulate_fleet(grid, path, cfg, model,
                              SimConfig(max_steps=STEPS - CKPT_STEPS), state,
                              table=table)
    torch.cuda.synchronize()
    if CKPT_STEPS != STEPS - CKPT_STEPS or caps:
        raise AssertionError(f"(c) the resumed call captured {len(caps)} "
                             "graphs; it should replay the cached ones")
    dt = time.perf_counter() - t0
    count(read_counts(), expect(admm_fused=STEPS, corridor_select=STEPS),
          "(c)")
    if step != CKPT_STEPS:
        raise AssertionError(f"(c) checkpoint step {step}")
    head = type(static_log)(*(f[:CKPT_STEPS] for f in static_log))
    tail = type(static_log)(*(f[CKPT_STEPS:] for f in static_log))
    same_log(first.log, head, "(c) first steps vs phase 5", static_log._fields)
    same_log(rest.log, tail, "(c) resumed steps vs phase 5", static_log._fields)
    print(f"[scale-out] (c) {CKPT_STEPS} steps, save_fleet_state, "
          f"load_fleet_state, {STEPS - CKPT_STEPS} steps at B={B} (the "
          f"first call's cached graphs replayed): the log "
          f"bitwise equal to phase 5's; {B * STEPS / dt:.1f} car-steps/s "
          f"({dt:.3f} s wall with the checkpoint) on {card}", flush=True)

    # (d) the profiling helpers beside the phases' own timings
    one_step = lambda: simulate_fleet(grid, path, cfg, model,
                                      SimConfig(max_steps=1), fleet,
                                      table=table)
    step_s = timeit(one_step, warmup=2, iters=10)
    step_ev = cuda_ms(one_step, 10)
    sm, S = model.safety_margin, cfg.max_segments
    k2_s = scan_marginal_cost(
        lambda b: corridor_select_cuda(b, S, sm), (s["blk"],),
        lambda a, i: (torch.roll(a[0], i % 2, 0),), steps=64, repeats=3)
    print(f"[profiling] timeit of one static step (B={B}, first step of "
          f"phase 5's fleet, a one-step rollout, which captures nothing; "
          f"CUDA events, median of 10): {step_s * 1e3:.4f} "
          f"ms; chip_smoke.cuda_ms of the same: {step_ev:.4f} ms; phase 5's "
          f"repeated call per step over {STEPS} steps: {s['main_ms']:.4f} ms."
          f"  "
          f"scan_marginal_cost of K2 (B={B}, 64 iterations on rolled "
          f"blocks, best of 3): {k2_s * 1e3:.5f} ms, beside [K2 scaling]'s "
          f"device time {s['k2_ms']:.5f} ms; on {card}", flush=True)
    return total


def graphs_phase(runs, api_ctx, nccl_runs, card, reset_counts, read_counts):
    """Phase 23 (module docstring): each path captured (its first call,
    after ``graphs.clear_cache()``) and called again on fresh inputs of
    the same shapes (the repeated call, which replays the cached graphs),
    each held bit for bit and launch for launch against the eager form
    (``graphs.disable_capture``) on its own inputs; the repeated call
    grows the allocator's reserve by nothing.  Times, capture seconds and
    peak memory of each form.

    ``runs``: ``(label, run, lanes, steps)``, ``run(fresh)`` a rollout on
    the first inputs or on the fresh ones; ``api_ctx``: :func:`api_world`'s
    arguments; ``nccl_runs(mesh)``: the runs to make over an NCCL group at
    world size 1."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_dist_worker import free_port

    from multi_purpose_mpc_tpu_torch.parallel.mesh import (global_fleet_mesh,
                                                           init_distributed)
    from multi_purpose_mpc_tpu_torch.utils import graphs
    from multi_purpose_mpc_tpu_torch.utils.profiling import capture_seconds
    from multi_purpose_mpc_tpu_torch.utils.tree import leaves

    def form(run, fresh, eager):
        """One call's result, wall, launches, captures, peak memory above
        what was allocated before it and the growth of the reserve."""
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        with (graphs.disable_capture() if eager
              else contextlib.nullcontext()), capture_seconds() as caps:
            res = run(fresh)
            torch.cuda.synchronize()
        return dict(res=res, wall=time.perf_counter() - t0,
                    launches=read_counts(), caps=list(caps),
                    peak=(torch.cuda.max_memory_allocated() - held) / 2**30,
                    grew=torch.cuda.memory_reserved() - reserved)

    def fingerprint(res):
        """Each leaf's sum (NaN read as 0), for telling two results apart."""
        return torch.stack([torch.nan_to_num(x.double()).sum()
                            for x in leaves(res)])

    def same_as_eager(label, a, b):
        la, lb = leaves(a["res"]), leaves(b["res"])
        bad = [i for i, (x, y) in enumerate(zip(la, lb)) if not same_bits(x, y)]
        if len(la) != len(lb) or bad:
            raise AssertionError(f"[graphs] {label}: leaves that differ from "
                                 f"the eager form's: {bad}")
        if a["launches"] != b["launches"]:
            raise AssertionError(f"[graphs] {label}: launches {a['launches']}"
                                 f" graphed, {b['launches']} eager")
        return len(la)

    def compare(label, run, lanes, steps):
        graphs.clear_cache()
        first = form(run, False, False)
        eager0 = form(run, False, True)
        n = same_as_eager(f"{label}, first call", first, eager0)
        mark = fingerprint(first["res"])
        first["res"] = eager0["res"] = None  # the caller drops its results
        hit = form(run, True, False)
        eager1 = form(run, True, True)
        same_as_eager(f"{label}, repeated call", hit, eager1)
        fresh = not torch.equal(mark, fingerprint(hit["res"]))
        if (len(first["caps"]) != 2 or hit["caps"] or eager0["caps"]
                or eager1["caps"] or hit["grew"] or not fresh):
            raise AssertionError(
                f"[graphs] {label}: graphs captured by the first call "
                f"{len(first['caps'])} (2 expected), by the repeated call "
                f"{len(hit['caps'])}, eagerly {len(eager0['caps'])} + "
                f"{len(eager1['caps'])}; the repeated call grew the reserve "
                f"by {hit['grew']} bytes; its results differ from the "
                f"first call's: {fresh}")
        ms = lambda f: f["wall"] / steps * 1e3
        cap_s, first_s, replay_ms = graph_times(first["wall"], first["caps"],
                                                steps)
        per_step = {k: v / steps for k, v in hit["launches"].items() if v}
        print(f"[graphs] {label}, B={lanes} x {steps} steps: {n} leaves "
              f"(logs, final state, maps) bitwise equal to the eager form's "
              f"for the first call and for the repeated call (fresh inputs "
              f"of the same shapes); launches a step {per_step} in each; ms "
              f"a step: repeated call {ms(hit):.4f} "
              f"({lanes * 1e3 / ms(hit):.1f} car-steps/s), first call "
              f"{ms(first):.4f} ({lanes * 1e3 / ms(first):.1f}; capture "
              f"{cap_s:.3f} s, first step {first_s * 1e3:.3f} ms, replays "
              f"{replay_ms:.4f}), eager {ms(eager1):.4f} on the fresh inputs"
              f" ({ms(eager0):.4f} on the first); peak memory above the held "
              f"{eager1['peak']:.3f} GiB eager, {first['peak']:.3f} first "
              f"call, {hit['peak']:.3f} repeated; the allocator's reserve "
              f"grew {first['grew'] / 2**30:.3f} GiB at the first call, "
              f"{hit['grew'] / 2**30:.3f} at the repeated call on {card}",
              flush=True)

    def api_loop(steps, lidar):
        """The two-call loop (with ``scan`` + ``update_map`` first when
        ``lidar``): each step's control and measurements, and the ms of
        ``get_control``, of ``drive`` (synchronised) and of the scan."""
        from multi_purpose_mpc_tpu_torch import api

        m, rp, car, ctrl = api_world(*api_ctx)
        sensor = api.LidarModel(FoV=180, range=2.0, resolution=2)
        out, ms = [], {"get_control": [], "drive": [], "scan": []}
        for _ in range(steps):
            if lidar:
                t0 = time.perf_counter()
                meas = sensor.scan(car, m)
                ms["scan"].append((time.perf_counter() - t0) * 1e3)
                sensor.update_map(car, m)
            t0 = time.perf_counter()
            u = ctrl.get_control()
            ms["get_control"].append((time.perf_counter() - t0) * 1e3)
            out.append(np.concatenate([u, meas.ravel()]) if lidar else u)
            t0 = time.perf_counter()
            car.drive(u)
            torch.cuda.synchronize()
            ms["drive"].append((time.perf_counter() - t0) * 1e3)
            if car.s >= rp.length:
                break
        return np.stack(out), ms

    for label, run, lanes, steps in runs:
        compare(label, run, lanes, steps)
    pct = lambda a, q: float(np.percentile(a, q))
    for label, steps, lidar in (("API lap", API_LAP_STEPS, False),
                                ("API LiDAR loop", API_LIDAR_STEPS, True)):
        with graphs.disable_capture():
            eager, eager_ms = api_loop(steps, lidar)
        graph, graph_ms = api_loop(steps, lidar)
        n = min(len(graph), len(eager))
        eq = np.all(graph[:n] == eager[:n], 1)
        same = n if eq.all() else int(np.argmin(eq))
        print(f"[graphs] {label}: {len(graph)} steps; controls"
              f"{' and measurements' if lidar else ''} bitwise equal to the "
              f"eager steps' on the first {same}; ms a step median / p99, "
              f"eager then replay (the first call, the step run eagerly as "
              f"the warm-up + the capture, apart): "
              + "; ".join(
                  f"{k} {pct(eager_ms[k], 50):.3f} / {pct(eager_ms[k], 99):.3f}"
                  f", {pct(v[1:], 50):.3f} / {pct(v[1:], 99):.3f} (first "
                  f"{v[0]:.1f})" for k, v in graph_ms.items() if v)
              + f" on {card}", flush=True)
        if len(graph) != len(eager) or same != n or n < API_GRAPH_STEPS:
            raise AssertionError(f"[graphs] {label}: graphed steps differ "
                                 "from the eager ones")
    if not init_distributed(f"localhost:{free_port()}", 1, 0, device="cuda"):
        raise AssertionError("init_distributed returned False")
    try:
        # set-up: NCCL builds its communicator at the group's first
        # collective, which would otherwise fall in the first graphed call
        dist.all_reduce(torch.zeros(1, device="cuda"))
        for label, run, lanes, steps in nccl_runs(global_fleet_mesh()):
            compare(f"NCCL at world size 1, {label}", run, lanes, steps)
    finally:
        # the cached graphs hold the group's all-reduce: freed before it
        graphs.clear_cache()
        dist.destroy_process_group()


def oracle_phase(dev, card, reset_counts, read_counts, expect):
    """Phase 20: the port held to the float64 oracle's fixtures
    (``tools/oracle_lap.py``) on the card.  Each per-step scenario's
    pre-step states go through one ``simulate_fleet`` step with K2 + K1
    (Schur) and again with K2 + K1-CR; the production lap and the two mode
    laps run the graphed ``simulate_closed_loop``.  Raises on any missed
    bar but the convex scenario's exception step (printed, not held)."""
    from multi_purpose_mpc_tpu_torch.config import SimConfig
    from multi_purpose_mpc_tpu_torch.simulation import simulate_closed_loop
    from tools import oracle_lap as ol

    misses = []
    for name in ol.PER_STEP:
        t0 = time.perf_counter()
        sc = ol.scenario(name, dev)
        lap = dict(np.load(ol.fixture(name)))
        for solver, counter in (("schur", "admm_fused"),
                                ("cr", "admm_fused_cr")):
            t1 = time.perf_counter()
            reset_counts()
            par = ol.parity(ol.port_step(sc, lap, solver), lap, name)
            launches = read_counts()
            print(f"[oracle] {name}, {solver}: {ol.describe(par)}; launches "
                  f"{launches}; {time.perf_counter() - t1:.2f} s "
                  f"({time.perf_counter() - t0:.2f} s with the scenario) on "
                  f"{card}", flush=True)
            if launches != expect(**{counter: 1, "corridor_select": 1}):
                raise AssertionError(f"oracle {name}, {solver} launches "
                                     f"{launches}")
            misses += [f"{name}, {solver}: {m}" for m in ol.misses(par, name)]

    t0 = time.perf_counter()
    sc = ol.scenario("production", dev)
    lap = dict(np.load(ol.fixture("production")))
    steps = sc["T"]
    reset_counts()
    res = simulate_closed_loop(sc["grid"], sc["path"], sc["cfg"], sc["model"],
                               SimConfig(max_steps=steps))
    launches = read_counts()
    fr = ol.free_run(res, lap)
    print(f"[oracle] production free run, {steps} steps graphed: lap "
          f"{fr['steps']} steps (oracle {fr['oracle_steps']}), done "
          f"{fr['done']}, accept {fr['accept']:.4f}, max pose distance from "
          f"the oracle's run {fr['pose_10']:.4f} m over 10 steps, "
          f"{fr['pose_40']:.4f} m over 40; launches {launches}; "
          f"{time.perf_counter() - t0:.2f} s on {card}", flush=True)
    if launches != expect(admm_fused=steps, corridor_select=steps):
        raise AssertionError(f"production lap launches {launches}")
    misses += [f"production: {m}" for m in ol.free_run_misses(fr)]

    t0 = time.perf_counter()
    ms = ol.mode_scenario(dev)
    reset_counts()
    m = ol.mode_laps(ms)
    launches = read_counts()
    tr, to = m["tracking"], m["time_optimal"]
    print(f"[modes] {ol.MODE_T} steps each, graphed: tracking lap "
          f"{tr['lap']} steps (done {tr['done']}), time-optimal lap "
          f"{to['lap']} steps (done {to['done']}, failed {to['failed']}), "
          f"mean v {to['v_mean']:.4f}, max |e_y| {to['max_ey']:.4f} m "
          f"(bar {m['ey_bar']:.4f}); launches {launches}; "
          f"{time.perf_counter() - t0:.2f} s on {card}", flush=True)
    if launches != expect(admm_fused=2 * ol.MODE_T,
                          corridor_select=2 * ol.MODE_T):
        raise AssertionError(f"mode laps launches {launches}")
    misses += [f"modes: {m}" for m in ol.mode_misses(m)]
    if misses:
        raise AssertionError(f"oracle bars missed on the card: {misses}")


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
    from multi_purpose_mpc_tpu_torch.utils.profiling import capture_seconds

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
    counted = kernels.launch_counters()

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
    centre = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution, obstacles)
    path = compute_speed_profile(centre, speed_cfg)
    table = static_horizon_table(grid, path, cfg, model)
    wp0, ey0 = feasible_starts(grid, path, cfg, model, B,
                               np.random.default_rng(SEED))
    fleet = init_fleet(path, cfg.N, B, e_y0=ey0, wp_id0=wp0)
    # the repeated calls' world: one more obstacle, another speed profile,
    # other starts; the same shapes
    grid2 = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                               [repeat_obstacle(centre, REPEAT_WP, REPEAT_R)])
    path2 = compute_speed_profile(centre, dataclasses.replace(
        speed_cfg, v_max=REPEAT_V_MAX))
    table2 = static_horizon_table(grid2, path2, cfg, model)

    def starts(g, p, c, n, lanes=None):
        wp, ey = feasible_starts(g, p, c, model, n,
                                 np.random.default_rng(SEED + 1))
        return init_fleet(p, c.N, lanes or n, e_y0=ey[:lanes],
                          wp_id0=wp[:lanes])

    fleet2 = starts(grid2, path2, cfg, B)
    # ... and on the first world's grid (the LiDAR fleets' true map)
    fleet_b = starts(grid, path2, cfg, B)
    fleet16_b = starts(grid, path2, cfg, B, LIDAR_B)
    if torch.equal(table, table2) or torch.equal(grid.occ, grid2.occ):
        raise AssertionError("the repeated calls' world equals the first")
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
    table60_2 = static_horizon_table(grid2, path2, cfg60, model)
    fleet60_2 = starts(grid2, path2, cfg60, N60_FLEET_B)
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
    def first_and_repeated(label, run, lanes, steps, expected, path_of):
        """``run(fresh)``, a rollout, twice: the first call captures, the
        repeated call (fresh inputs of the same shapes) replays the cached
        graphs.  Launch counts and health gates on both; prints the
        repeated call's rate, the headline, the first call's beside it.
        Returns ``(first result, repeated ms a step, first call's replays
        ms a step)``."""
        out, ms = [], []
        for fresh in (False, True):
            reset_counts()
            t0 = time.perf_counter()
            with capture_seconds() as caps:
                res = run(fresh)
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = read_counts()
            if got != expected:
                raise AssertionError(f"{label} launches {got}")
            if fresh and caps:
                raise AssertionError(f"{label}: the repeated call captured")
            h = health(res.log, res.final_state, path_of(fresh), model, steps)
            check_health(h, f"{label}{', repeated call' if fresh else ''}")
            out.append((res, dt, caps, h))
        (res, dt1, caps, h1), (_, dt2, _, h2) = out
        cap_s, first_s, replay_ms = graph_times(dt1, caps, steps)
        print(f"[{label}] {lanes * steps / dt2:.1f} car-steps/s, the repeated "
              f"call (fresh starts, speed profile, obstacle and table of the "
              f"same shapes; the cached graphs replayed {steps} times, "
              f"{dt2 / steps * 1e3:.4f} ms a step), {fmt_health(h2)}; the "
              f"first call {lanes * steps / dt1:.1f} car-steps/s ({dt1:.3f} s"
              f" wall: capture {cap_s:.3f} s, first step "
              f"{first_s * 1e3:.3f} ms, replays {replay_ms:.4f} ms a step), "
              f"{fmt_health(h1)}; launches {expected} each, on {card}",
              flush=True)
        return res, dt2 / steps * 1e3, replay_ms

    res, main_ms, replay_ms = first_and_repeated(
        "main", lambda fresh: simulate_fleet(
            *((grid2, path2) if fresh else (grid, path)), cfg, model,
            SimConfig(max_steps=STEPS), fleet2 if fresh else fleet,
            table=table2 if fresh else table), B, STEPS,
        expect(admm_fused=STEPS, corridor_select=STEPS),
        lambda fresh: path2 if fresh else path)
    launches = expect(admm_fused=STEPS, corridor_select=STEPS)
    static_log = res.log
    profile_steps(f"static grid B={B}", lambda fresh: simulate_fleet(
        *((grid2, path2) if fresh else (grid, path)), cfg, model,
        SimConfig(max_steps=10), fleet2 if fresh else fleet,
        table=table2 if fresh else table),
        10, main_ms, replay_ms, card,
        {"admm_fused_kernel": "admm_fused",
         "corridor_select_kernel": "corridor_select"})

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
    rt_centre = build_reference_path(rt_grid, rt_path_cfg)
    rt_path = compute_speed_profile(rt_centre, rt_speed)

    def rt_starts(p, seed):
        rng = np.random.default_rng(seed)  # bench.py's draw (bench.py:198-204)
        return init_fleet(
            p, rt_cfg.N, RT_BATCH,
            e_y0=torch.tensor(rng.uniform(-0.1, 0.1, RT_BATCH),
                              dtype=torch.float32, device=dev),
            wp_id0=torch.tensor(rng.integers(0, p.n_wp // 2, RT_BATCH),
                                dtype=torch.int32, device=dev))

    rt_fleet = rt_starts(rt_path, SEED)
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
    # phase 23's repeated Real_Track call: one more obstacle, another
    # speed profile, other starts
    rt_grid2 = add_obstacles_host(
        rt_grid, rt_map.origin, rt_map.resolution,
        [repeat_obstacle(rt_centre, RT_REPEAT_WP, RT_REPEAT_R)])
    rt_path2 = compute_speed_profile(rt_centre, dataclasses.replace(
        rt_speed, v_max=REPEAT_V_MAX))
    rt_fleet2 = rt_starts(rt_path2, SEED + 1)

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
    disc_packed = disc.pop("packed")  # phase 22's per-lane reference
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
        one line with the lane's shared memory, the lanes a block and the
        lanes resident per SM."""
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
        lanes, per_sm = admm_cuda.occupancy(
            "fused" if kernel == "K1-CR" else "structured", cfg.N, True)
        print(f"[{kernel} scaling] N={cfg.N}, kernel ms per batch: "
              + ", ".join(line) + f"; a lane "
              f"{admm_cuda.lane_smem_bytes(cfg.N, True)} B of shared "
              f"memory, {lanes} lanes a block, {per_sm} lanes resident per "
              f"SM ({card})", flush=True)
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
    cr_run = lambda steps: lambda fresh: simulate_fleet(
        *((grid2, path2) if fresh else (grid, path)), cfg_cr, model,
        SimConfig(max_steps=steps), fleet2 if fresh else fleet,
        table=table2 if fresh else table)
    cr_res, cr_ms, cr_replay_ms = first_and_repeated(
        "cr fleet", cr_run(STEPS), B, STEPS,
        expect(admm_fused_cr=STEPS, corridor_select=STEPS),
        lambda fresh: path2 if fresh else path)
    cr_launches = expect(admm_fused_cr=STEPS, corridor_select=STEPS)
    h_cr = health(cr_res.log, cr_res.final_state, path, model, STEPS)
    h_s = health(static_log, res.final_state, path, model, STEPS)
    print(f"[cr fleet] stage_solver=cr, static grid, B={B} x {STEPS} steps: "
          f"first call accept {h_cr['accept']:.4f}, solver-failure "
          f"{h_cr['solver_fail']:.5f}; Schur fleet (phase 5) accept "
          f"{h_s['accept']:.4f}, solver-failure {h_s['solver_fail']:.5f} on "
          f"{card}", flush=True)
    # the CR results are bitwise those of the kernels' earlier design, so
    # the fleet's first call reads as it did then (same seed)
    got = (f"{h_cr['accept']:.4f}", f"{h_cr['solver_fail']:.5f}",
           h_cr["failed"], f"{h_cr['max_ey']:.4f}")
    was = CR_FLEET_BEFORE
    print(f"[cr fleet] first call accept {got[0]}, solver-failure {got[1]}, "
          f"failed lanes {got[2]}, max|e_y| {got[3]}; earlier design accept "
          f"{was[0]}, solver-failure {was[1]}, failed lanes {was[2]}, "
          f"max|e_y| {was[3]}: {'equal' if got == was else 'DIFFERENT'}",
          flush=True)
    if got != was:
        raise AssertionError(f"CR fleet moved: {got} against {was}")
    profile_steps(f"static grid, CR, B={B}", cr_run(10), 10, cr_ms,
                  cr_replay_ms, card,
                  {"admm_fused_kernel": "admm_fused_cr",
                   "corridor_select_kernel": "corridor_select"})
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

    # ---- phase 20: the float64 oracle in four task modes ----
    oracle_phase(dev, card, reset_counts, read_counts, expect)

    # ---- phase 21: the two-call loop through the object API ----
    api_phase(map_cfg, path_cfg, model, cfg, speed_cfg, obstacles, card,
              reset_counts, read_counts, expect)

    # ---- phase 22: the scale-out path, checkpoint / resume, profiling ----
    scale = scale_out_phase(dict(
        grid=grid, path=path, cfg=cfg, model=model, fleet=fleet, table=table,
        static_log=static_log, main_ms=main_ms, lidar=lidar, scan=scan,
        cells=cells, free=free, fleet16=fleet16, dyn_sim=dyn_sim,
        disc_packed=disc_packed, blk=blk, k2_ms=k2_ms), card, reset_counts,
        read_counts, expect)

    # ---- phase 23: every path's graph against its eager form ----
    from multi_purpose_mpc_tpu_torch.parallel.fleet import (
        simulate_fleet_sharded, simulate_lidar_fleet_sharded)

    def nccl_runs(mesh):
        return [
            ("simulate_fleet_sharded, static grid",
             lambda fresh: simulate_fleet_sharded(
                 mesh, *w1(fresh), cfg, model, SimConfig(max_steps=STEPS),
                 fl(fresh)), B, STEPS),
            ("simulate_lidar_fleet_sharded, shared grid, clear_free (the "
             "mask all-reduce captured)",
             lambda fresh: simulate_lidar_fleet_sharded(
                 mesh, grid, free, pl(fresh), cfg, model, dyn_sim, lidar,
                 fleet16_b if fresh else fleet16, shared_grid=True,
                 clear_free=True, **lidar_kw), LIDAR_B, STEPS)]

    # each run(fresh): on the first inputs, or on fresh ones of the same
    # shapes (the second world on the static and dynamic grids; new starts
    # and a new speed profile on the LiDAR paths' true map; other weights)
    w1 = lambda fresh: (grid2, path2) if fresh else (grid, path)
    tb = lambda fresh: table2 if fresh else table
    fl = lambda fresh: fleet2 if fresh else fleet
    scan2 = corridor_extract.build_scanline_table(grid2, path2,
                                                  cfg.n_scan_samples)
    weights2 = WeightSet(*(w.roll(-1, 0) for w in weights))
    pl = lambda fresh: path2 if fresh else path
    graphs_phase([
        ("static grid, Schur", lambda fresh: simulate_fleet(
            *w1(fresh), cfg, model, SimConfig(max_steps=STEPS), fl(fresh),
            table=tb(fresh)), B, STEPS),
        ("static grid, CR", lambda fresh: simulate_fleet(
            *w1(fresh), cfg_cr, model, SimConfig(max_steps=STEPS), fl(fresh),
            table=tb(fresh)), B, STEPS),
        ("dynamic grid", lambda fresh: simulate_fleet(
            *w1(fresh), cfg, model, dyn_sim, fl(fresh),
            table=scan2 if fresh else scan), B, STEPS),
        ("dynamic sweep", lambda fresh: simulate_fleet(
            *w1(fresh), cfg, model, dyn_sim, fl(fresh),
            table=scan2 if fresh else scan,
            weights=weights2 if fresh else weights), B, STEPS),
        ("escalation", lambda fresh: simulate_fleet(
            *w1(fresh), esc_cfg, model, SimConfig(max_steps=ESC_STEPS),
            fl(fresh), table=tb(fresh)), B, ESC_STEPS),
        (f"N = {N60}", lambda fresh: simulate_fleet(
            *w1(fresh), cfg60, model, SimConfig(max_steps=N60_STEPS),
            fleet60_2 if fresh else fleet60,
            table=table60_2 if fresh else table60), N60_FLEET_B, N60_STEPS),
        ("Real_Track (table built inside)", lambda fresh: simulate_fleet(
            *((rt_grid2, rt_path2) if fresh else (rt_grid, rt_path)), rt_cfg,
            rt_model, SimConfig(max_steps=RT_STEPS),
            rt_fleet2 if fresh else rt_fleet), RT_BATCH, RT_STEPS),
        ("LiDAR fleet, known = true (packed)", lambda fresh: simulate_lidar_fleet(
            grid, grid, pl(fresh), cfg, model, dyn_sim, lidar,
            fleet_b if fresh else fleet, **lidar_kw), B, STEPS),
        *((f"discovery fleet, {wb}", lambda fresh, wb=wb: simulate_lidar_fleet(
            grid, free, pl(fresh), cfg, model, dyn_sim, lidar,
            fleet16_b if fresh else fleet16, writeback_backend=wb,
            **lidar_kw), LIDAR_B, STEPS)
          for wb in ("packed", "fused")),
        ("single-car lap", lambda fresh: simulate_closed_loop(
            *w1(fresh), cfg, model, SimConfig(max_steps=250),
            state0=init_car_state(pl(fresh), cfg.N), table=tb(fresh)), 1,
         250),
        ("single-car LiDAR loop", lambda fresh: simulate_lidar_loop(
            grid, free, pl(fresh), cfg, model,
            SimConfig(max_steps=LOOP_STEPS), lidar,
            state0=init_car_state(pl(fresh), cfg.N), table=scan), 1,
         LOOP_STEPS),
    ], (map_cfg, path_cfg, model, cfg, speed_cfg, obstacles), nccl_runs,
        card, reset_counts, read_counts)

    def row(name, replaces, launches, err, ms, plain_ms, bnd, library_ms=None,
            source=None):
        return {"name": name, "route": "cuda",
                "source": f"multi_purpose_mpc_tpu_torch/csrc/{source or name}.cu",
                "replaces": f"multi_purpose_mpc_tpu/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    # launches: the path's run in its phase plus phase 22's runs (its
    # ranks' included).  library_ms: one PyTorch call computing the same
    # function exists only for K4 (advanced indexing); none solves the QPs,
    # selects corridors or writes and reads a map in one call
    print(json.dumps({"kernels": [
        row("corridor_select", "ops/corridor_pallas.py:38",
            launches["corridor_select"] + scale["corridor_select"], k2_err,
            k2_ms, k2_plain_ms, k2_bound),
        row("admm_fused", "ops/admm_pallas.py:271",
            launches["admm_fused"] + scale["admm_fused"], k1_err, k1_ms,
            k1_plain_ms, k1_bound),
        row("admm_structured", "ops/admm_pallas.py:1001",
            sweep_launches["admm_structured"], k3_err, k3_ms, k3_plain_ms,
            k3_bound),
        row("extract_occ", "ops/corridor_extract.py:210",
            dyn_launches["extract_occ"] + scale["extract_occ"], k4_err, k4_ms,
            k4_plain_ms, k4_bound, k4_lib_ms),
        row("writeback_extract", "ops/mapping_pallas.py:41",
            disc_launches["fused"]["writeback_extract"], k56_err, k5_ms,
            k5_plain_ms, k5_bound),
        row("writeback_extract_packed", "ops/mapping_pallas.py:169",
            lidar_launches["writeback_extract_packed"]
            + scale["writeback_extract_packed"], k56_err, k6_ms,
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
