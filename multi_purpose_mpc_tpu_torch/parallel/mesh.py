"""The fleet mesh over ranks (port of ``parallel/mesh.py``).

Lanes never interact, so a fleet scales out as the JAX package's 1-D
``"fleet"`` mesh does: every per-lane tensor (the ``CarState`` leaves,
logs, per-lane maps) is split on its leading batch axis into one
contiguous block per rank, world data (grid, path, tables) is replicated,
and the only collectives are the metric reductions of
:func:`fleet_metrics` and, for a shared LiDAR map, the per-step mask pool
(:func:`~..ops.lidar.pool_observation_masks`).

A rank is one process of a ``torch.distributed`` process group: NCCL on
the card (one GPU per rank), gloo on the CPU.  Placement is explicit —
:func:`shard_fleet_state` takes this rank's block, :func:`replicate`
moves world data to its device — so the JAX package's GSPMD placement
objects ``fleet_sharding`` and ``replicated`` (``NamedSharding``) have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from multi_purpose_mpc_tpu_torch.utils.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """This rank's place in the fleet: its rank, the world size, its device
    and the process group (None outside ``torch.distributed``)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None


def _rank_device(device) -> torch.device:
    """``device`` with the CUDA index this process was bound to."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def fleet_mesh(device="cuda", group=None) -> FleetMesh:
    """The mesh of ``group`` (the default group when None) if
    ``torch.distributed`` is initialised, else a one-rank mesh; lanes live
    on ``device`` (the card unless the caller names another device)."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        return FleetMesh(dist.get_rank(group), dist.get_world_size(group),
                         _rank_device(device), group)
    if group is not None:
        raise ValueError("a process group needs torch.distributed initialised")
    return FleetMesh(0, 1, _rank_device(device))


def global_fleet_mesh(device="cuda") -> FleetMesh:
    """One fleet axis over every rank of the default group: lanes span all
    processes (on every host).  The same as :func:`fleet_mesh` by
    construction."""
    return fleet_mesh(device)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> bool:
    """Join the fleet's process group: ``init_process_group`` with NCCL for
    ``device="cuda"`` (one GPU per rank), gloo for ``device="cpu"`` (gloo
    also all-reduces CUDA tensors, so ranks sharing one card use it).

    Coordinates come from the arguments (``coordinator_address`` is
    ``host:port``), else from torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``
    / ``WORLD_SIZE`` / ``RANK``.  A CUDA rank is bound to
    ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` defaults to the
    process id).  Returns True if the group is (or already was) up, and
    False without connecting anywhere when there are no coordinates, so a
    single process never pays a timeout."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    device = torch.device(device)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"init_distributed needs {name} (argument or "
                         "environment) with a coordinator address")
    return int(os.environ[name])


def local_lane_slice(global_batch: int, process_index: int,
                     process_count: int) -> slice:
    """Which contiguous lane block process ``process_index`` owns.

    Pure logic (unit-testable without multi-host hardware): lanes divide
    evenly across processes in device order, matching how a 1-D mesh over
    ``jax.devices()`` lays out the leading batch axis.  ``global_batch``
    must already be a multiple of ``process_count`` (use
    :func:`round_up_batch` with the global mesh first).
    """
    if global_batch % process_count:
        raise ValueError(
            f"global_batch {global_batch} not divisible by process_count "
            f"{process_count}; round_up_batch first")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def round_up_batch(batch: int, mesh: FleetMesh) -> int:
    """Lanes must divide evenly across ranks; pad the fleet if needed."""
    n = mesh.world_size
    return ((batch + n - 1) // n) * n


def lane_block(mesh: FleetMesh, batch: int) -> slice:
    """This rank's lanes of a fleet of ``batch``."""
    return local_lane_slice(batch, mesh.rank, mesh.world_size)


def shard_fleet_state(state, mesh: FleetMesh):
    """This rank's lane block of a batched tree (a ``CarState``, a
    ``WeightSet``: every leaf with the leading batch axis), on its
    device."""
    batch = _batch(state)
    sl = lane_block(mesh, batch)
    return tree_map(lambda x: torch.as_tensor(x)[sl].to(mesh.device), state)


def _batch(tree) -> int:
    sizes = {x.shape[0] for x in leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"leaves disagree on the batch axis: {sorted(sizes)}")
    return sizes.pop()


def replicate(tree, mesh: FleetMesh):
    """World data (grid, path, tables) on this rank's device."""
    return tree_map(lambda x: torch.as_tensor(x).to(mesh.device), tree)


def fleet_metrics(log, length, mesh: Optional[FleetMesh] = None):
    """Cross-fleet aggregates of a rollout log (T, B): progress, completion,
    acceptance, speed and tracking — the five scalars of the JAX package's
    ``fleet_metrics``, as 0-d float32 tensors on the log's device.

    Under a distributed ``mesh`` each rank passes its block's log: the
    local sums (float64), counts and maximum are all-reduced (SUM, MAX)
    over the group, then divided as the JAX function divides, so every
    rank gets the whole fleet's values.  Without a mesh, or with one rank,
    the same sums are taken on the one log.
    """
    active = log.active
    dev = log.s.device
    f64 = torch.float64
    sums = torch.stack([
        (log.s[-1] / length).to(f64).sum(),
        (log.s[-1] >= length).to(f64).sum(),
        (log.ok & active).to(f64).sum(),
        active.to(f64).sum(),
        (log.v * active).to(f64).sum(),
        torch.tensor(float(log.s.shape[1]), dtype=f64, device=dev)])
    max_ey = (log.e_y * active).abs().max().reshape(1)
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(max_ey, op=dist.ReduceOp.MAX, group=mesh.group)
    prog, laps, solved, n_active, speed, lanes = sums
    n_active = torch.clamp(n_active, min=1.0)
    f32 = torch.float32
    return {
        "mean_progress": (prog / lanes).to(f32),
        "laps_done": (laps / lanes).to(f32),
        "qp_solve_rate": (solved / n_active).to(f32),
        "mean_speed": (speed / n_active).to(f32),
        "max_abs_e_y": max_ey[0],
    }
