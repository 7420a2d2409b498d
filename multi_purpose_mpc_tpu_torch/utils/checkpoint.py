"""Fleet checkpoint / resume (port of ``utils/checkpoint.py``).

The complete simulator state is the :class:`~..models.bicycle.CarState`
tree (its ``SolverCarry`` nested), so a checkpoint is a flat dump of its
leaves.  The helpers are generic over trees (``utils/tree.py``): the
LiDAR fleet checkpoints its ``(CarState, known_occ)`` carry the same way.

``save_fleet_state`` / ``load_fleet_state`` write the JAX package's
``.npz`` format — ``leaf_{i}`` in ``jax.tree.flatten``'s order, plus
``__step__`` — and the two packages' ``CarState`` fields line up, so a
file written by either loads in the other bit for bit.
``save_fleet_state_torch`` / ``load_fleet_state_torch`` stand where the
JAX package's Orbax pair stands: ``torch.save`` of the flat leaves.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.utils.tree import leaves, rebuild


def _restore(like, arrays):
    """``like`` with its leaves taken from ``arrays`` (in order), each on
    the leaf's device and in its dtype; shapes must match."""
    ref = leaves(like)
    if len(arrays) != len(ref):
        raise ValueError(f"checkpoint holds {len(arrays)} leaves, the state "
                         f"{len(ref)}")
    out = []
    for i, (a, l) in enumerate(zip(arrays, ref)):
        t = torch.as_tensor(a).to(device=l.device, dtype=l.dtype)
        if t.shape != l.shape:
            raise ValueError(f"leaf_{i}: checkpoint shape {tuple(t.shape)}, "
                             f"state shape {tuple(l.shape)}")
        out.append(t)
    return rebuild(like, out)


def save_fleet_state(path: str, state, step: int = 0) -> None:
    """Snapshot a (batched) fleet state, or any tree of tensors, to
    ``path`` (``.npz`` appended unless given)."""
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(leaves(state))}
    arrays["__step__"] = np.asarray(step)
    np.savez(path, **arrays)


def load_fleet_state(path: str, like) -> Tuple[object, int]:
    """Restore a fleet state; ``like`` supplies the tree, the devices and
    the dtypes.  Returns ``(state, step)``."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        arrays = [data[f"leaf_{i}"] for i in range(n)]
        step = int(data["__step__"])
    return _restore(like, arrays), step


def _step_file(dirpath: str, step: int) -> str:
    return os.path.join(os.path.abspath(dirpath), f"step_{step}")


def save_fleet_state_torch(dirpath: str, state, step: int = 0) -> None:
    """``torch.save`` of the state's flat leaves (host copies) into
    ``dirpath/step_{step}``, for long Monte-Carlo runs."""
    os.makedirs(dirpath, exist_ok=True)
    torch.save([x.detach().cpu() for x in leaves(state)],
               _step_file(dirpath, step))


def load_fleet_state_torch(dirpath: str, like, step: int):
    """The state :func:`save_fleet_state_torch` wrote at ``step``, loaded
    with ``weights_only=True`` onto ``like``'s devices and dtypes."""
    arrays = torch.load(_step_file(dirpath, step), map_location="cpu",
                        weights_only=True)
    return _restore(like, arrays)
