"""Closed-loop rollouts (port of ``multi_purpose_mpc_tpu/simulation.py``).

The JAX package compiles each rollout into one ``lax.scan``; here
:func:`_rollout` writes the same loop in a graph-ready form: the carry
(the fleet's :class:`CarState`, and the LiDAR fleet's maps) lives in two
sets of static buffers, step ``t`` reads one set and writes the other, and
writes its log row into preallocated (T, B) logs at a device-side step
counter.  On the card the step is captured once per buffer set as a CUDA
graph (:mod:`.utils.graphs`) and replayed ``sim.max_steps`` times with no
Python between the steps; on the CPU, and for a rollout that all-reduces
over a gloo group, the same form runs eagerly.  Logs, final states and
kernel launches are the same either way, bit for bit.

* static grid: free segments and the windowed horizon table are built once
  per rollout; every step goes through the table, kernel K2 and kernel K1;
* dynamic grid (``SimConfig(static_grid=False)``): the scanline table is
  built once per rollout, and every step re-extracts the free segments
  from the grid (kernel K4), writes them into the horizon block and
  selects the corridor (K2) before the solve;
* ``weights``: a per-lane :class:`~.mpc.WeightSet` sweep on either grid,
  solved by kernel K3 instead of K1;
* LiDAR in the loop (:func:`simulate_lidar_fleet`,
  :func:`simulate_lidar_loop`): every step scans the true world, writes the
  hits into the known maps and re-extracts the corridor from them — on the
  card through kernel K6 (bit-packed per-lane maps) or K5, which write and
  extract in one launch, then K2 and K1 (K3 under ``weights``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.config import (LidarConfig, MPCConfig,
                                                ModelConfig, SimConfig)
from multi_purpose_mpc_tpu_torch.models.bicycle import (
    CarState, drive, horizon_indices, init_car_state)
from multi_purpose_mpc_tpu_torch.mpc import (
    ControlOutput, WeightSet, corridor_violation_floor, mpc_corridor,
    mpc_locate, mpc_step_batched, mpc_step_batched_with_corridor)
from multi_purpose_mpc_tpu_torch.ops.constraints import (
    SegmentCandidates, extract_all_segments)
from multi_purpose_mpc_tpu_torch.ops.corridor_cuda import corridor_select
from multi_purpose_mpc_tpu_torch.ops.corridor_extract import (
    ScanlineTable, build_scanline_table, fleet_dynamic_segments,
    horizon_segments, horizon_tables)
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
    build_horizon_table, empty_segments, horizon_block_from_segments,
    solver_inputs_from_block)
from multi_purpose_mpc_tpu_torch.ops.lidar import (
    apply_observation_masks, fleet_observation_masks, fleet_writeback,
    hit_pixels, occupied_cell_table, pool_observation_masks, scan_fleet,
    scatter_writeback_, waypoint_cell_table, waypoint_slack)
from multi_purpose_mpc_tpu_torch.ops.mapping import (
    pack_rows, unpack_rows, writeback_extract, writeback_extract_packed)
from multi_purpose_mpc_tpu_torch.ops.path import PathData, gather_waypoint_index
from multi_purpose_mpc_tpu_torch.utils import graphs
from multi_purpose_mpc_tpu_torch.utils.tree import leaves, rebuild


class SimLog(NamedTuple):
    """Per-step logs, (T, B) each (time-major, like the JAX package)."""

    x: torch.Tensor
    y: torch.Tensor
    psi: torch.Tensor
    v: torch.Tensor
    delta: torch.Tensor
    s: torch.Tensor
    e_y: torch.Tensor
    status: torch.Tensor  # raw solver status (SOLVED/MAX_ITER/DIVERGED)
    ok: torch.Tensor  # control accepted (reference-semantics acceptance)
    r_prim: torch.Tensor  # QP primal residual
    floor: torch.Tensor  # certified violation floor (> 0: QP infeasible)
    active: torch.Tensor


class SimResult(NamedTuple):
    final_state: CarState
    log: SimLog


def _post_control(out: ControlOutput, path: PathData, model: ModelConfig):
    """Plant step + one step of logs after a fleet control step."""
    st = out.state
    active = ~(st.done | st.failed)
    v = torch.where(active, out.v, torch.zeros_like(out.v))
    delta = torch.where(active, out.delta, torch.zeros_like(out.delta))
    st = drive(st, path, v, delta, model.length, model.Ts)
    # end of lap: the reference's loop condition (simulation.py:134)
    st = dataclasses.replace(st, done=st.done | (st.s >= path.length))
    log = SimLog(x=st.x, y=st.y, psi=st.psi, v=v, delta=delta, s=st.s,
                 e_y=st.e_y, status=out.status, ok=out.ok, r_prim=out.r_prim,
                 floor=out.floor, active=active)
    return st, log


def static_horizon_table(grid: GridMap, path: PathData, cfg: MPCConfig,
                         model: ModelConfig) -> torch.Tensor:
    """Free segments at every waypoint + the windowed horizon table: the
    once-per-rollout setup of the static-grid path."""
    segs = extract_all_segments(grid, path, 2.0 * model.safety_margin,
                                n_samples=cfg.n_scan_samples,
                                max_segments=cfg.max_segments)
    return build_horizon_table(path, segs, cfg)


def simulate_fleet(grid: GridMap, path: PathData, cfg: MPCConfig,
                   model: ModelConfig, sim: SimConfig, state0: CarState,
                   table=None, weights: Optional[WeightSet] = None) -> SimResult:
    """Fleet closed-loop rollout of ``sim.max_steps`` steps; ``state0``
    carries a leading batch axis.

    ``sim.static_grid=True``: ``table`` is a prebuilt horizon table
    (:func:`static_horizon_table`).  ``False``: the corridor is re-extracted
    from ``grid`` every step, and ``table`` is a prebuilt
    :class:`~.ops.corridor_extract.ScanlineTable`.  Either is built here
    when omitted.  ``weights``: a per-lane :class:`~.mpc.WeightSet` (leaves
    with a leading batch axis), a controller-tuning sweep."""
    _validate_weights(weights, state0)
    if sim.static_grid:
        if table is None:
            table = static_horizon_table(grid, path, cfg, model)
        step = lambda st, _: _post_control(
            mpc_step_batched(st, path, cfg, model, table, weights=weights),
            path, model)
        return SimResult(*_rollout(step, state0, sim.max_steps))
    if table is None:
        table = build_scanline_table(grid, path, cfg.n_scan_samples)
    return _simulate_fleet_dynamic(grid, path, cfg, model, sim, state0, table,
                                   weights)


def _rollout(sim_step, carry0, steps: int, group=None):
    """``steps`` applications of ``sim_step(carry, dst) -> (carry, log)``
    from ``carry0`` (a tree: a :class:`CarState`, or a tuple of it and
    the maps); returns ``(final carry, logs)``, the logs a tree like the
    step's (a :class:`SimLog`) with a leading time axis.

    The carry lives in two sets of static buffers; step ``t`` reads set
    ``t % 2`` and its result is copied into the other set, so a new leaf
    that views an old one is never overwritten before it is read.
    ``dst`` is the set being written, as a tree like the carry: a step
    may write a leaf there itself (an ``out=`` buffer) and return that
    tensor, which is then not copied.  A step keeps every leaf's shape
    and dtype, as ``lax.scan``'s carry does.

    Captured as CUDA graphs (one per buffer set, sharing a memory pool)
    under :func:`~.utils.graphs.should_capture` of the carry's device and
    ``group``: on the card unless ``group`` is a gloo group, whose
    all-reduce goes through the host; eager otherwise.  The first step
    runs eagerly as the graphs' warm-up and the other ``steps - 1``
    replay them (a one-step rollout captures nothing)."""
    if steps < 1:
        raise ValueError(f"a rollout takes at least one step, got {steps}")
    first = leaves(carry0)
    dev = first[0].device
    bufs = ([x.clone(memory_format=torch.contiguous_format) for x in first],
            [torch.empty_like(x, memory_format=torch.contiguous_format)
             for x in first])
    t = torch.zeros((), dtype=torch.int64, device=dev)
    logs, log_like = [], []
    graphed = steps > 1 and graphs.should_capture(dev, group)
    # the logs outlive the warm-up's side stream: they are made on the
    # caller's
    logs_stream = (torch.cuda.stream(torch.cuda.current_stream(dev))
                   if graphed else contextlib.nullcontext())

    def step(parity: int):
        src, dst = bufs[parity], bufs[1 - parity]
        new, log = sim_step(rebuild(carry0, src), rebuild(carry0, dst))
        if not logs:
            log_like.append(log)
            with logs_stream:
                logs.extend(torch.empty((steps,) + tuple(f.shape),
                                        dtype=f.dtype, device=f.device)
                            for f in leaves(log))
        for buf, row in zip(logs, leaves(log)):
            buf.index_copy_(0, t, row.unsqueeze(0))
        t.add_(1)
        _copy_carry(leaves(new), dst)

    if graphed:
        g1 = graphs.StepGraph(lambda: step(1), warmup=lambda: step(0))
        pair = (graphs.StepGraph(lambda: step(0), pool=g1.pool())
                if steps > 2 else None, g1)
        for i in range(1, steps):
            pair[i % 2].replay()
    else:
        for i in range(steps):
            step(i % 2)
    return rebuild(carry0, bufs[steps % 2]), rebuild(log_like[0], logs)


def _copy_carry(new, dst) -> None:
    """Copy a step's new carry leaves into the buffer set ``dst``."""
    if len(new) != len(dst):
        raise ValueError(f"a step returned {len(new)} carry leaves for "
                         f"{len(dst)}")
    for n, d in zip(new, dst):
        if n.shape != d.shape or n.dtype != d.dtype:
            raise ValueError(
                f"a step must keep its carry's shapes and dtypes: "
                f"{tuple(d.shape)} {d.dtype} became {tuple(n.shape)} "
                f"{n.dtype}")
        if n is not d:
            d.copy_(n)


def _validate_weights(weights: Optional[WeightSet], state0: CarState) -> None:
    """Fail fast on a mis-batched WeightSet: every non-None leaf needs a
    leading fleet axis matching the state batch."""
    if weights is None:
        return
    B = state0.batch
    for name, leaf, width in (("Q", weights.Q, 3), ("R", weights.R, 2),
                              ("QN", weights.QN, 3)):
        if leaf is None:
            continue
        if leaf.dim() != 2 or leaf.shape[0] != B or leaf.shape[1] != width:
            raise ValueError(
                f"WeightSet.{name} must have shape ({B}, {width}) to match "
                f"the fleet batch; got {tuple(leaf.shape)}")


def _simulate_fleet_dynamic(grid: GridMap, path: PathData, cfg: MPCConfig,
                            model: ModelConfig, sim: SimConfig,
                            state0: CarState, scan: ScanlineTable,
                            weights: Optional[WeightSet]) -> SimResult:
    """Dynamic-grid rollout on ``grid.occ`` (shared (H, W)); the horizon
    table supplies the pose and solver columns, the segment columns come
    from each step's extraction."""
    base = build_horizon_table(
        path, empty_segments(path.n_wp, cfg.max_segments, path.x.device), cfg)
    step = lambda st, _: _sim_step_batched_gridded(st, path, grid.occ, cfg,
                                                   model, scan, base, weights)
    return SimResult(*_rollout(step, state0, sim.max_steps))


def _locate_horizon(state: CarState, path: PathData, cfg: MPCConfig):
    """Fleet localization + the (B, N) horizon waypoint indices of the
    corridor stages (from wp_id + 1, like the reference, MPC.py:116)."""
    located = mpc_locate(state, path)
    offs = torch.arange(cfg.N, device=located[0].device)
    idx = gather_waypoint_index(path, located[0].long()[:, None] + 1,
                                offs[None, :])
    return located, idx


def _dynamic_corridor_batched(state: CarState, path: PathData,
                              occ: torch.Tensor, scan: ScanlineTable,
                              table: torch.Tensor, cfg: MPCConfig,
                              model: ModelConfig):
    """Fleet localization + dynamic-grid corridor; ``occ`` is per-lane
    (B, H, W) or shared (H, W).  Returns ``(located, corridor, block)``."""
    located, idx = _locate_horizon(state, path, cfg)
    sm = model.safety_margin
    segs = fleet_dynamic_segments(occ, scan, idx, 2.0 * sm, cfg.max_segments)
    corridor, blk = _select_corridor_batched(table, located[0], segs, cfg, sm)
    return located, corridor, blk


def _select_corridor_batched(table: torch.Tensor, wp_id: torch.Tensor,
                             segs: SegmentCandidates, cfg: MPCConfig, sm):
    """Corridor selection (kernel K2) from per-lane segment candidates,
    through the horizon block of ``wp_id``.  Returns ``(corridor, block)``."""
    blk = horizon_block_from_segments(table, wp_id, segs)
    return corridor_select(blk, cfg.max_segments, sm), blk


def _sim_step_batched_gridded(state: CarState, path: PathData,
                              occ: torch.Tensor, cfg: MPCConfig,
                              model: ModelConfig, scan: ScanlineTable,
                              table: torch.Tensor,
                              weights: Optional[WeightSet] = None):
    """Fleet step on a per-step occupancy grid, per-lane (B, H, W) or
    shared (H, W): extraction (K4), selection (K2), the solve (K1, or K3
    under ``weights``) fed from the same horizon block, then the plant
    step and logs."""
    located, corridor, blk = _dynamic_corridor_batched(state, path, occ, scan,
                                                       table, cfg, model)
    out = mpc_step_batched_with_corridor(
        state, cfg, model, located, corridor,
        solver_inputs_from_block(blk, cfg.max_segments), weights=weights)
    return _post_control(out, path, model)


def simulate_closed_loop(grid: GridMap, path: PathData, cfg: MPCConfig,
                         model: ModelConfig, sim: SimConfig,
                         state0: Optional[CarState] = None,
                         table: Optional[torch.Tensor] = None) -> SimResult:
    """Single-car rollout: the fleet path at batch 1 (the kernels included).
    Logs come back as (T,); ``final_state`` keeps its batch axis of 1."""
    if state0 is None:
        state0 = init_car_state(path, cfg.N)
    if state0.batch != 1:
        raise ValueError(f"simulate_closed_loop takes one car, got {state0.batch}")
    res = simulate_fleet(grid, path, cfg, model, sim, state0, table=table)
    return SimResult(final_state=res.final_state,
                     log=SimLog(*(f[:, 0] for f in res.log)))


def resolve_lidar_backends(shared_grid: bool, clear_free: bool,
                           scan_backend: str, writeback_backend: str,
                           multi_device: bool = False, device="cuda"):
    """Resolve ``"auto"`` scan / write-back backends for grids on
    ``device`` and validate the combination.

    On the card the policy is the JAX package's TPU policy: scan ``cells``;
    write-back ``packed`` (kernel K6) for per-lane maps without
    ``clear_free``, ``dense`` for a shared grid or with ``clear_free``.  On
    the CPU it is the JAX package's CPU policy, ``march`` / ``scatter``.
    ``multi_device=True`` (a sharded shared grid) forces ``dense``: the
    pooling across devices rides the observation masks."""
    on_card = torch.device(device).type == "cuda"
    if scan_backend == "auto":
        scan_backend = "cells" if on_card else "march"
    if writeback_backend == "auto":
        if shared_grid:
            writeback_backend = "dense" if on_card or multi_device else "scatter"
        elif on_card:
            writeback_backend = "packed" if not clear_free else "dense"
        else:
            writeback_backend = "scatter"
    if writeback_backend not in ("scatter", "dense", "fused", "packed"):
        raise ValueError(f"unknown writeback backend {writeback_backend!r}")
    if writeback_backend in ("fused", "packed") and (shared_grid or clear_free):
        raise ValueError(f"{writeback_backend} writeback supports per-lane "
                         "grids with clear_free=False; use 'dense' or "
                         "'scatter'")
    if multi_device and shared_grid and writeback_backend != "dense":
        raise ValueError("multi-device shared-grid mapping pools observation "
                         "masks across devices; writeback_backend must be "
                         "'dense'")
    return scan_backend, writeback_backend


def resolve_cell_table(true_grid: GridMap, path: PathData, lidar: LidarConfig,
                       cells, scan_backend: str, prune: bool = True):
    """The ``cells`` scan's static table: the global boundary-cell table of
    ``true_grid`` unless ``cells`` is given, upgraded with ``prune`` to the
    per-waypoint table whenever that pays (K < 3/4 M); exact for on-track
    poses (radius = range + :func:`~.ops.lidar.waypoint_slack`).  None for
    other scan backends."""
    if scan_backend != "cells":
        return None
    if cells is None:
        cells = occupied_cell_table(true_grid.occ)
    if prune and cells.dim() == 2:
        wpc = waypoint_cell_table(cells, true_grid, path,
                                  lidar.range + waypoint_slack(path))
        if wpc.shape[1] < 0.75 * cells.shape[0]:
            cells = wpc
    return cells


def simulate_lidar_fleet(true_grid: GridMap, known_grid: GridMap,
                         path: PathData, cfg: MPCConfig, model: ModelConfig,
                         sim: SimConfig, lidar: LidarConfig, state0: CarState,
                         clear_free: bool = False, shared_grid: bool = False,
                         table: Optional[ScanlineTable] = None, cells=None,
                         scan_backend: str = "auto",
                         writeback_backend: str = "auto",
                         prune_cells: bool = True,
                         weights: Optional[WeightSet] = None, group=None):
    """Fleet LiDAR-in-the-loop rollout of ``sim.max_steps`` steps: every
    step each lane scans ``true_grid``, writes the hits into its known map,
    re-extracts its corridor from the updated map and solves.  The
    controller never sees ``true_grid``.

    * ``shared_grid=False``: per-lane maps; ``known_grid.occ`` (H, W) is
      copied to every lane, or is already (B, H, W).
    * ``shared_grid=True``: one map, updated by every lane each step
      (observed-free clearing pooled first, hits after).
    * ``clear_free``: cells a beam saw as free are cleared (a map refresh
      for changing scenes).

    Backends (:func:`resolve_lidar_backends`): ``scatter`` / ``dense``
    write the scans into the maps and run the dynamic-grid step (kernel K4,
    free runs, K2, then K1, or K3 under ``weights``); ``fused`` / ``packed``
    write and extract in one launch (kernel K5 on float32 maps, K6 on maps
    bit-packed 32 rows per word), then free runs, K2 and the solve.
    ``table``: a prebuilt :class:`ScanlineTable`; ``cells``: the ``cells``
    scan's table (:func:`resolve_cell_table`).  ``weights``: a per-lane
    :class:`~.mpc.WeightSet`.

    ``group``: a ``torch.distributed`` process group whose ranks each run
    a block of one fleet on one shared map (the counterpart of the JAX
    package's ``axis_name``; :func:`~.parallel.fleet.simulate_lidar_fleet_sharded`
    passes it).  Every step pools the observation masks over the group
    (:func:`~.ops.lidar.pool_observation_masks`) before the one map update,
    so every rank's map stays the same; it needs ``shared_grid`` and the
    ``dense`` write-back.  Over NCCL the all-reduce is captured with the
    step; a gloo group's rollout runs eagerly (gloo reduces through the
    host, which a CUDA graph cannot hold).

    Returns ``(SimResult, final_known_occ)``: (B, H, W) per lane, or
    (H, W)."""
    _validate_weights(weights, state0)
    if group is not None and not shared_grid:
        raise ValueError("pooling maps over a process group needs "
                         "shared_grid=True; per-lane maps shard with their "
                         "lanes")
    dev = known_grid.device
    if table is None:
        # pure geometry: a resumed (B, H, W) stack builds from its frame
        frame = known_grid
        if known_grid.occ.dim() == 3:
            frame = dataclasses.replace(known_grid, occ=known_grid.occ[0])
        table = build_scanline_table(frame, path, cfg.n_scan_samples)
    scan_backend, writeback_backend = resolve_lidar_backends(
        shared_grid, clear_free, scan_backend, writeback_backend,
        multi_device=group is not None, device=dev)
    cells = resolve_cell_table(true_grid, path, lidar, cells, scan_backend,
                               prune=prune_cells)
    B = state0.batch
    base = build_horizon_table(
        path, empty_segments(path.n_wp, cfg.max_segments, path.x.device), cfg)
    H, W = known_grid.occ.shape[-2:]
    sm = model.safety_margin

    def lanes(occ):
        """The map carry: per-lane maps from a 2-D frame (the rollout
        copies it into its own buffers), a (B, H, W) stack or the shared
        grid as they are."""
        return occ.expand(B, -1, -1) if not shared_grid and occ.dim() == 2 \
            else occ

    def scans_of(st):
        return scan_fleet(true_grid, st.x, st.y, st.psi, lidar, cells=cells,
                          backend=scan_backend, wp_id=st.wp_id)

    if writeback_backend in ("fused", "packed"):
        packed = writeback_backend == "packed"
        fused = writeback_extract_packed if packed else writeback_extract

        def step(carry, dst):
            # the kernel writes the new maps straight into the other
            # buffer set: two maps ping-pong, none is copied
            st, occ = carry
            located, idx = _locate_horizon(st, path, cfg)
            h = horizon_tables(table, idx)
            scans = scans_of(st)
            hpx, hpy = hit_pixels(known_grid, scans, H, W)
            occ, vals = fused(occ, hpx.contiguous(), hpy.contiguous(),
                              scans.hit.contiguous(), h.px, h.py, out=dst[1])
            segs = horizon_segments(vals, h, 2.0 * sm, cfg.max_segments)
            corridor, blk = _select_corridor_batched(base, located[0], segs,
                                                     cfg, sm)
            out = mpc_step_batched_with_corridor(
                st, cfg, model, located, corridor,
                solver_inputs_from_block(blk, cfg.max_segments),
                weights=weights)
            st, log = _post_control(out, path, model)
            return (st, occ), log

        occ = known_grid.occ
        (st, occ), log = _rollout(
            step, (state0, lanes(pack_rows(occ) if packed else occ)),
            sim.max_steps)
        return SimResult(st, log), unpack_rows(occ, H) if packed else occ

    def step(carry, _):
        st, occ = carry
        scans = scans_of(st)
        if group is not None:
            masks = fleet_observation_masks(known_grid, H, W, st.x, st.y,
                                            st.psi, scans, lidar,
                                            clear_free=clear_free, shared=True)
            occ = apply_observation_masks(
                occ, *pool_observation_masks(*masks, group))
        elif writeback_backend == "dense":
            occ = fleet_writeback(known_grid, occ, st.x, st.y, st.psi, scans,
                                  lidar, clear_free=clear_free,
                                  shared=shared_grid)
        else:
            scatter_writeback_(known_grid, occ, st.x, st.y, st.psi, scans,
                               clear_free=clear_free, shared=shared_grid)
        st, log = _sim_step_batched_gridded(st, path, occ, cfg, model, table,
                                            base, weights)
        return (st, occ), log

    (st, occ), log = _rollout(step, (state0, lanes(known_grid.occ)),
                              sim.max_steps, group=group)
    return SimResult(st, log), occ


def simulate_lidar_loop(true_grid: GridMap, known_grid: GridMap,
                        path: PathData, cfg: MPCConfig, model: ModelConfig,
                        sim: SimConfig, lidar: LidarConfig,
                        state0: Optional[CarState] = None,
                        clear_free: bool = False,
                        table: Optional[ScanlineTable] = None,
                        scan_backend: str = "auto",
                        writeback_backend: str = "auto"):
    """Single-car LiDAR-in-the-loop rollout (BASELINE.json config 4): the
    fleet path at batch 1, kernels included.  Logs come back as (T,), the
    final known map as a :class:`GridMap` (H, W); ``final_state`` keeps its
    batch axis of 1.  Returns ``(SimResult, final_known_grid)``."""
    if state0 is None:
        state0 = init_car_state(path, cfg.N)
    if state0.batch != 1:
        raise ValueError(f"simulate_lidar_loop takes one car, got {state0.batch}")
    res, occ = simulate_lidar_fleet(true_grid, known_grid, path, cfg, model,
                                    sim, lidar, state0, clear_free=clear_free,
                                    table=table, scan_backend=scan_backend,
                                    writeback_backend=writeback_backend)
    return (SimResult(final_state=res.final_state,
                      log=SimLog(*(f[:, 0] for f in res.log))),
            dataclasses.replace(known_grid, occ=occ[0]))


def init_fleet(path: PathData, N: int, batch: int, e_y0=None, e_psi0=None,
               wp_id0=None) -> CarState:
    """Batch of initial states, optionally perturbed per lane."""
    dev = path.x.device
    zeros = torch.zeros(batch, dtype=torch.float32, device=dev)
    return init_car_state(
        path, N, zeros if e_y0 is None else e_y0,
        zeros if e_psi0 is None else e_psi0,
        torch.zeros(batch, dtype=torch.int32, device=dev)
        if wp_id0 is None else wp_id0)


def feasible_starts(grid: GridMap, path: PathData, cfg: MPCConfig,
                    model: ModelConfig, batch: int, rng: np.random.Generator,
                    e_y_scale: float = 0.03, margin: float = 2e-3,
                    max_rounds: int = 8):
    """Draw ``batch`` Monte-Carlo starts (wp_id0, e_y0) whose first QP is
    certified feasible: clip each e_y into the start corridor, resample
    lanes whose violation floor is still positive.  Draws from ``rng`` in
    the same order as the JAX package, so one seed gives both packages the
    same starts.  Returns (wp_id0 (B,) int32, e_y0 (B,) float32)."""
    dev = path.x.device
    segs = extract_all_segments(grid, path, 2.0 * model.safety_margin,
                                n_samples=cfg.n_scan_samples,
                                max_segments=cfg.max_segments)

    def check(wp, ey):
        w = torch.as_tensor(wp, dtype=torch.int32, device=dev)
        e = torch.as_tensor(np.asarray(ey, np.float32), device=dev)
        cor = mpc_corridor(w, path, cfg, model, segs)
        lo = cor.lb[:, 0] + margin
        hi = cor.ub[:, 0] - margin
        e = torch.minimum(torch.maximum(e, torch.minimum(lo, hi)), hi)
        idx = horizon_indices(path, w, cfg.N)
        horizon = (path.v_ref[idx], path.kappa[idx], path.seg_dist[idx])
        fl = corridor_violation_floor(e, torch.zeros_like(e), horizon, cor,
                                      cfg, model)
        return e.cpu().numpy(), fl.cpu().numpy()

    wp = rng.integers(0, path.n_wp, batch)
    ey = rng.uniform(-e_y_scale, e_y_scale, batch)
    for _ in range(max_rounds):
        ey, fl = check(wp, ey)
        bad = fl > 0
        if not bad.any():
            break
        wp[bad] = rng.integers(0, path.n_wp, int(bad.sum()))
        ey[bad] = rng.uniform(-e_y_scale, e_y_scale, int(bad.sum()))
    else:
        # pathological leftovers: the start waypoint (always feasible)
        ey, fl = check(wp, ey)
        bad = fl > 0
        wp[bad] = 0
        ey[bad] = 0.0
    return (torch.as_tensor(wp, dtype=torch.int32, device=dev),
            torch.as_tensor(ey, dtype=torch.float32, device=dev))
