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
from multi_purpose_mpc_tpu_torch.ops.constraints import SegmentCandidates
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap
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
