"""Flat views of nested state: the port's counterpart of ``jax.tree``.

A tree is a dataclass (``CarState``, ``SolverCarry``, ``GridMap``), a
tuple, list or NamedTuple (``SimResult``, ``SimLog``, ``(CarState,
known_occ)``), or a dict, nested in any way; its leaves are the tensors
and numpy arrays in it, in ``jax.tree.flatten``'s order: dataclass fields
and tuple items in declaration order, dict entries by sorted key.  Other
values (``PathData.circular``, None) are structure, not leaves, as a
flax ``pytree_node=False`` field is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def leaves(tree) -> List:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    out: List = []

    def walk(t):
        if _is_leaf(t):
            out.append(t)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name))
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])

    walk(tree)
    return out


def rebuild(like, new_leaves) -> object:
    """``like`` with its leaves replaced, in order, by ``new_leaves``;
    raises unless their number matches."""
    it: Iterator = iter(new_leaves)

    def build(t):
        if _is_leaf(t):
            return next(it)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name))
                for f in dataclasses.fields(t) if f.init})
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return t

    try:
        out = build(like)
    except StopIteration:
        raise ValueError("fewer leaves than the tree has") from None
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    return rebuild(tree, [fn(x) for x in leaves(tree)])
