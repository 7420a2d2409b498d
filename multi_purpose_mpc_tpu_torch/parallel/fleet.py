"""Sharded fleet rollouts: the multi-rank entry points (port of
``parallel/fleet.py``).

Each rank runs the whole local rollout — the kernels included on the card
— on its contiguous block of lanes, as each device of the JAX package's
``shard_map`` does.  Lanes are independent, so the static and dynamic
fleets and the per-lane LiDAR fleet run with zero collectives; a shared
LiDAR map pools its observation masks over the group once per mask class
each step; :func:`~.mesh.fleet_metrics` and :func:`gather_fleet` reduce
and assemble afterwards.

The escalation pass (``SolverConfig.escalate_lanes``) picks its top-k
rejected lanes per rank, as the JAX ``shard_map`` body picks them per
shard: a sharded fleet re-solves up to k lanes on every rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from multi_purpose_mpc_tpu_torch.config import (LidarConfig, MPCConfig,
                                                ModelConfig, SimConfig)
from multi_purpose_mpc_tpu_torch.models.bicycle import CarState
from multi_purpose_mpc_tpu_torch.ops.corridor_extract import build_scanline_table
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap
from multi_purpose_mpc_tpu_torch.ops.path import PathData
from multi_purpose_mpc_tpu_torch.parallel.mesh import (FleetMesh, lane_block,
                                                       replicate,
                                                       shard_fleet_state)
from multi_purpose_mpc_tpu_torch.simulation import (SimResult, simulate_fleet,
                                                    simulate_lidar_fleet)
from multi_purpose_mpc_tpu_torch.utils.tree import rebuild, leaves


def simulate_fleet_sharded(mesh: FleetMesh, grid: GridMap, path: PathData,
                           cfg: MPCConfig, model: ModelConfig, sim: SimConfig,
                           state0: CarState) -> SimResult:
    """The fleet rollout with the batch axis split over the ranks of
    ``mesh``: this rank's lane block of ``state0`` (the whole fleet, its
    batch a multiple of the world size, see ``round_up_batch``), on the
    replicated grid and path.  For ``sim.static_grid=False`` the rank
    builds the scanline table itself, outside the rollout.  Returns this
    rank's block as a :class:`SimResult` (:func:`gather_fleet` assembles
    the fleet)."""
    state = shard_fleet_state(state0, mesh)
    grid, path = replicate(grid, mesh), replicate(path, mesh)
    table = None
    if not sim.static_grid:
        table = build_scanline_table(grid, path, cfg.n_scan_samples)
    return simulate_fleet(grid, path, cfg, model, sim, state, table=table)


def simulate_lidar_fleet_sharded(mesh: FleetMesh, true_grid: GridMap,
                                 known_grid: GridMap, path: PathData,
                                 cfg: MPCConfig, model: ModelConfig,
                                 sim: SimConfig, lidar: LidarConfig,
                                 state0: CarState, clear_free: bool = False,
                                 shared_grid: bool = False,
                                 scan_backend: str = "auto",
                                 writeback_backend: str = "auto",
                                 table=None, cells=None):
    """LiDAR-in-the-loop fleet with its lanes (and their maps) split over
    the ranks of ``mesh``: the multi-rank flavour of
    :func:`~..simulation.simulate_lidar_fleet`.

    * ``shared_grid=False``: per-lane maps shard with their lanes (a
      (B, H, W) ``known_grid`` stack is cut to this rank's block, an
      (H, W) frame is copied to each local lane); zero collectives.  On
      the card the maps are bit-packed (kernel K6).
    * ``shared_grid=True``: one map, replicated; every step each rank pools
      its lanes' observation masks and one MAX all-reduce per mask class
      merges them over the group (``dense`` write-back), so every rank's
      map stays bit for bit the same, as one device pooling all lanes.

    World inputs (true grid, path, ``table``, ``cells``) are replicated.
    Returns ``(SimResult, final_known_occ)``: this rank's lanes and their
    maps, or the shared map."""
    state = shard_fleet_state(state0, mesh)
    occ = known_grid.occ
    if not shared_grid and occ.dim() == 3:
        occ = occ[lane_block(mesh, occ.shape[0])]
    known = replicate(dataclasses.replace(known_grid, occ=occ), mesh)
    true_grid, path = replicate(true_grid, mesh), replicate(path, mesh)
    if table is not None:
        table = replicate(table, mesh)
    if cells is not None:
        cells = replicate(cells, mesh)
    return simulate_lidar_fleet(
        true_grid, known, path, cfg, model, sim, lidar, state,
        clear_free=clear_free, shared_grid=shared_grid, table=table,
        cells=cells, scan_backend=scan_backend,
        writeback_backend=writeback_backend,
        group=mesh.group if shared_grid else None)


def gather_fleet(result: SimResult, mesh: FleetMesh) -> SimResult:
    """The whole fleet from every rank's block: logs (T, B, ...) and the
    final state (B, ...), on every rank, on its device.  gloo gathers only
    host tensors, so under gloo the blocks travel through the host."""
    if mesh.group is None or mesh.world_size == 1:
        return result
    host = dist.get_backend(mesh.group) == dist.Backend.GLOO

    def gather(x: torch.Tensor, axis: int) -> torch.Tensor:
        send = x.contiguous()
        if host:
            send = send.cpu()
        parts = [torch.empty_like(send) for _ in range(mesh.world_size)]
        dist.all_gather(parts, send, group=mesh.group)
        return torch.cat(parts, axis).to(mesh.device)

    state = rebuild(result.final_state, [
        gather(x, 0) for x in leaves(result.final_state)])
    log = rebuild(result.log, [gather(x, 1) for x in leaves(result.log)])
    return SimResult(final_state=state, log=log)
