"""State carried across from the JAX package, and back.

The system has no learned weights; its state is the scenario and the
fleet.  These helpers turn the JAX package's pytrees — or anything whose
fields ``numpy.asarray`` accepts, so this module never imports jax — into
the port's tensors on a given device, and turn the port's results back
into numpy.  Tests use them so that downstream parity does not depend on
setup noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.models.bicycle import CarState
from multi_purpose_mpc_tpu_torch.mpc import WeightSet
from multi_purpose_mpc_tpu_torch.ops.constraints import SegmentCandidates
from multi_purpose_mpc_tpu_torch.ops.corridor_extract import ScanlineTable
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap
from multi_purpose_mpc_tpu_torch.ops.lidar import LidarScan
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import SolverCarry
from multi_purpose_mpc_tpu_torch.ops.path import PathData


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.array(a), device=device)


def _fields(obj, cls, device, skip=()):
    return {f.name: _tensor(getattr(obj, f.name), device)
            for f in dataclasses.fields(cls) if f.name not in skip}


def grid_map(grid, device="cpu") -> GridMap:
    return GridMap(**_fields(grid, GridMap, device))


def path_data(path, device="cpu") -> PathData:
    return PathData(**_fields(path, PathData, device, skip=("circular",)),
                    circular=bool(path.circular))


def segment_candidates(segs, device="cpu") -> SegmentCandidates:
    return SegmentCandidates(*(_tensor(getattr(segs, f), device)
                               for f in SegmentCandidates._fields))


def scanline_table(table, device="cpu") -> ScanlineTable:
    """The JAX package's ``ScanlineTable`` (its Mosaic-only ``row0`` /
    ``window_rows`` dropped)."""
    return ScanlineTable(*(_tensor(getattr(table, f), device)
                           for f in ScanlineTable._fields))


def lidar_scan(scan, device="cpu") -> LidarScan:
    """A ``LidarScan`` (one scan or a fleet's, leading batch axis kept)."""
    return LidarScan(*(_tensor(getattr(scan, f), device)
                       for f in LidarScan._fields))


def occupancy(occ, device="cpu") -> torch.Tensor:
    """An occupancy grid (H, W) or per-lane stack (B, H, W), float32."""
    return torch.tensor(np.asarray(occ, np.float32), device=device)


def weight_set(ws, device="cpu") -> WeightSet:
    """A ``WeightSet``, ``None`` leaves kept, float32."""
    leaf = lambda a: None if a is None else torch.tensor(
        np.asarray(a, np.float32), device=device)
    return WeightSet(*(leaf(getattr(ws, f)) for f in WeightSet._fields))


def solver_carry(carry, device="cpu") -> SolverCarry:
    return SolverCarry(**_fields(carry, SolverCarry, device))


def car_state(state, device="cpu") -> CarState:
    """A fleet state (leading batch axis), solver carry included."""
    return CarState(**_fields(state, CarState, device, skip=("solver",)),
                    solver=solver_carry(state.solver, device))


def to_numpy(obj):
    """Tensors -> numpy arrays, through NamedTuples (e.g. ``SimLog``) and
    dataclasses (e.g. ``CarState``), keeping their types."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_numpy(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(obj, f.name))})
    return obj
