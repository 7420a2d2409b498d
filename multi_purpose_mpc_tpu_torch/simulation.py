"""Closed-loop rollouts (port of ``multi_purpose_mpc_tpu/simulation.py``).

The JAX package compiles each rollout into one ``lax.scan``; here
:func:`_rollout` writes the same loop in a graph-ready form: the carry
(the fleet's :class:`CarState`, and the LiDAR fleet's maps) lives in two
sets of static buffers, step ``t`` reads one set and writes the other, and
writes its log row into preallocated (T, B) logs at a device-side step
counter.  On the card the step is captured once per buffer set as a CUDA
graph (:mod:`.utils.graphs`) and replayed ``sim.max_steps`` times with no
Python between the steps; the graphs are cached, as ``jax.jit`` caches
the JAX package's compiled rollouts, so a later call of the same
configuration and shapes copies its fresh inputs in and only replays.
On the CPU, and for a rollout that all-reduces over a gloo group, the
same form runs eagerly.  Logs, final states and kernel launches are the
same either way, bit for bit.

* static grid: free segments and the windowed horizon table are built once
  per rollout; every step goes through the table, kernel K2 and kernel K1;
* dynamic grid (``SimConfig(static_grid=False)``): the scanline table is
  built once per rollout, and every step re-extracts the free segments
  from the grid (kernel K4, then its free runs, K8), writes them into the
  horizon block and selects the corridor (K2) before the solve;
* ``weights``: a per-lane :class:`~.mpc.WeightSet` sweep on either grid,
  solved by kernel K3 instead of K1;
* LiDAR in the loop (:func:`simulate_lidar_fleet`,
  :func:`simulate_lidar_loop`): every step scans the true world, writes the
  hits into the known maps and re-extracts the corridor from them — on the
  card through kernel K6 (bit-packed per-lane maps) or K5, which write and
  extract in one launch, then K8, K2 and K1 (K3 under ``weights``).
"""

from __future__ import annotations

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
    horizon_pixels, horizon_segments_from_table)
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
    build_horizon_table, empty_segments, horizon_block_from_segments,
    solver_inputs_from_block)
from multi_purpose_mpc_tpu_torch.ops.lidar import (
    apply_observation_masks, fleet_observation_masks, fleet_writeback,
    hit_pixels, occupied_cell_table, pool_observation_masks, scan_fleet,
    scatter_writeback_, waypoint_cells)
from multi_purpose_mpc_tpu_torch.ops.mapping import (
    pack_rows, unpack_rows, writeback_extract, writeback_extract_packed)
from multi_purpose_mpc_tpu_torch.ops.path import PathData, gather_waypoint_index
from multi_purpose_mpc_tpu_torch.utils import graphs, spans
from multi_purpose_mpc_tpu_torch.utils.tree import leaves, signature, tree_map


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
    spans.stage("post")
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


@spans.call_span("rollout", "rollout")
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
        step = lambda st, _, x: _post_control(
            mpc_step_batched(st, x["path"], cfg, model, x["table"],
                             weights=x["weights"]), x["path"], model)
        return SimResult(*_rollout(
            step, state0, sim.max_steps,
            inputs=dict(path=path, table=table, weights=weights),
            key=("fleet, static grid", cfg, model)))
    if table is None:
        table = build_scanline_table(grid, path, cfg.n_scan_samples)
    return _simulate_fleet_dynamic(grid, path, cfg, model, sim, state0, table,
                                   weights)


def _rollout(sim_step, carry0, steps: int, group=None, inputs=(), key=()):
    """``steps`` applications of ``sim_step(carry, dst, inputs) -> (carry,
    log)`` from ``carry0`` (a tree: a :class:`CarState`, or a tuple of it
    and the maps); returns ``(final carry, logs)``, the logs a tree like
    the step's (a :class:`SimLog`) with a leading time axis.

    The carry lives in two sets of static buffers; step ``t`` reads set
    ``t % 2`` and its result is copied into the other set, so a new leaf
    that views an old one is never overwritten before it is read.
    ``dst`` is the set being written, as a tree like the carry: a step
    may write a leaf there itself (an ``out=`` buffer) and return that
    tensor, which is then not copied.  A step keeps every leaf's shape
    and dtype, as ``lax.scan``'s carry does.

    ``inputs``: every tensor the step reads besides the carry (a tree:
    the path, tables, grids, weights), handed to it as copies, as
    ``jax.jit`` traces its non-static arguments; the step reads no tensor
    from a closure.  ``key``: everything else the step reads (a name for
    the step, its configs by value, the backends), hashable.

    Captured as CUDA graphs (one per buffer set, sharing a memory pool)
    under :func:`~.utils.graphs.should_capture` of the carry's device and
    ``group``: on the card unless ``group`` is a gloo group, whose
    all-reduce goes through the host; eager otherwise, and for one step.
    The graphs are cached (:data:`~.utils.graphs.rollout_cache`) under
    ``key``, ``steps``, ``group`` and the shapes, dtypes and devices of
    ``carry0`` and ``inputs``.  The first call runs its first step
    eagerly as the warm-up, captures and replays the graphs for the other
    ``steps - 1``; a later call with the same key copies its ``carry0``
    and ``inputs`` in and replays all ``steps``.  A graphed call returns
    copies: the entry's buffers belong to its next call.

    Inside the public entry's host span ``rollout`` (its request id the
    call's; :func:`~.utils.spans.call_span`) the call's children are
    ``inputs`` (the entry's own work), then ``steps`` (eager), or
    ``lookup`` (the cache key), ``capture`` / ``copy_in``, ``replay`` (the
    replays' launch loop) and ``result`` (the copies); each step's stages
    go to the entry's stage ring (:mod:`~.utils.spans`)."""
    if steps < 1:
        raise ValueError(f"a rollout takes at least one step, got {steps}")
    dev = leaves(carry0)[0].device
    if steps == 1 or not graphs.should_capture(dev, group):
        spans.phase("steps")
        entry = graphs.RolloutEntry(carry0, inputs, steps)
        for i in range(steps):
            entry.step(sim_step, i % 2)
        return entry.result()
    spans.phase("lookup")
    full_key = (tuple(key), steps, None if group is None else id(group),
                signature((carry0, inputs)))
    entry = graphs.rollout_cache.get(dev, full_key)
    if entry is None:
        spans.phase("capture")
        entry = graphs.RolloutEntry(carry0, inputs, steps, group)
        entry.capture_pair(sim_step)
        graphs.rollout_cache.put(dev, full_key, entry)
        first = 1
    else:
        spans.phase("copy_in")
        entry.copy_in((carry0, inputs))
        entry.t.zero_()
        first = 0
    spans.phase("replay")
    for i in range(first, steps):
        entry.replay(entry.pair[i % 2])
    spans.phase("result")
    return tree_map(torch.clone, entry.result())


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
    step = lambda st, _, x: _sim_step_batched_gridded(
        st, x["path"], x["occ"], cfg, model, x["scan"], x["base"],
        x["weights"])
    return SimResult(*_rollout(
        step, state0, sim.max_steps,
        inputs=dict(path=path, occ=grid.occ, scan=scan, base=base,
                    weights=weights),
        key=("fleet, dynamic grid", cfg, model)))


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
    spans.stage("locate")
    located, idx = _locate_horizon(state, path, cfg)
    sm = model.safety_margin
    spans.stage("extract")
    segs = fleet_dynamic_segments(occ, scan, idx, 2.0 * sm, cfg.max_segments)
    spans.stage("select")
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
    per-waypoint :class:`~.ops.lidar.CellTable` whenever that pays (K <
    3/4 M); exact for every pose (a lane past its waypoint's reach sweeps
    the global table).  None for other scan backends."""
    if scan_backend != "cells":
        return None
    if cells is None:
        cells = occupied_cell_table(true_grid.occ)
    if prune and isinstance(cells, torch.Tensor) and cells.dim() == 2:
        table = waypoint_cells(cells, true_grid, path, lidar.range)
        if table.rows.shape[1] < 0.75 * cells.shape[0]:
            cells = table
    return cells


@spans.call_span("rollout", "rollout")
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
    the free runs (K8), K2, then K1, or K3 under ``weights``); ``fused`` /
    ``packed`` write and extract in one launch (kernel K5 on float32 maps,
    K6 on maps bit-packed 32 rows per word), then K8, K2 and the solve.
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
    # the known map's geometry: a resumed (B, H, W) stack's from its frame
    frame = known_grid
    if known_grid.occ.dim() == 3:
        frame = dataclasses.replace(known_grid, occ=known_grid.occ[0])
    if table is None:
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
    # the step's tensors: of the known map only its frame (the maps are
    # the carry)
    inputs = dict(true=true_grid, cells=cells, frame=frame, path=path,
                  table=table, base=base, weights=weights)
    key = ("LiDAR fleet", cfg, model, lidar, scan_backend, writeback_backend,
           clear_free, shared_grid, H, W)

    def lanes(occ):
        """The map carry: per-lane maps from a 2-D frame (the rollout
        copies it into its own buffers), a (B, H, W) stack or the shared
        grid as they are."""
        return occ.expand(B, -1, -1) if not shared_grid and occ.dim() == 2 \
            else occ

    def scans_of(st, x):
        return scan_fleet(x["true"], st.x, st.y, st.psi, lidar,
                          cells=x["cells"], backend=scan_backend,
                          wp_id=st.wp_id)

    if writeback_backend in ("fused", "packed"):
        packed = writeback_backend == "packed"
        fused = writeback_extract_packed if packed else writeback_extract

        def step(carry, dst, x):
            # the kernel writes the new maps straight into the other
            # buffer set: two maps ping-pong, none is copied
            st, occ = carry
            path = x["path"]
            spans.stage("locate")
            located, idx = _locate_horizon(st, path, cfg)
            px, py = horizon_pixels(x["table"], idx)
            spans.stage("scan")
            scans = scans_of(st, x)
            hpx, hpy = hit_pixels(x["frame"], scans, H, W)
            spans.stage("writeback")
            occ, vals = fused(occ, hpx.contiguous(), hpy.contiguous(),
                              scans.hit.contiguous(), px, py, out=dst[1])
            spans.stage("free_runs")
            segs = horizon_segments_from_table(vals, x["table"], idx, 2.0 * sm,
                                               cfg.max_segments)
            spans.stage("select")
            corridor, blk = _select_corridor_batched(x["base"], located[0],
                                                     segs, cfg, sm)
            out = mpc_step_batched_with_corridor(
                st, cfg, model, located, corridor,
                solver_inputs_from_block(blk, cfg.max_segments),
                weights=x["weights"])
            st, log = _post_control(out, path, model)
            return (st, occ), log

        occ = known_grid.occ
        (st, occ), log = _rollout(
            step, (state0, lanes(pack_rows(occ) if packed else occ)),
            sim.max_steps, inputs=inputs, key=key)
        return SimResult(st, log), unpack_rows(occ, H) if packed else occ

    def step(carry, _, x):
        st, occ = carry
        spans.stage("scan")
        scans = scans_of(st, x)
        frame = x["frame"]
        spans.stage("writeback")
        if group is not None:
            masks = fleet_observation_masks(frame, H, W, st.x, st.y, st.psi,
                                            scans, lidar,
                                            clear_free=clear_free, shared=True)
            # the all-reduces wait for the slowest rank: a stage of its own
            spans.stage("pool")
            occ = apply_observation_masks(
                occ, *pool_observation_masks(*masks, group))
        elif writeback_backend == "dense":
            occ = fleet_writeback(frame, occ, st.x, st.y, st.psi, scans,
                                  lidar, clear_free=clear_free,
                                  shared=shared_grid)
        else:
            scatter_writeback_(frame, occ, st.x, st.y, st.psi, scans,
                               clear_free=clear_free, shared=shared_grid)
        st, log = _sim_step_batched_gridded(st, x["path"], occ, cfg, model,
                                            x["table"], x["base"],
                                            x["weights"])
        return (st, occ), log

    (st, occ), log = _rollout(step, (state0, lanes(known_grid.occ)),
                              sim.max_steps, group=group, inputs=inputs,
                              key=key)
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
