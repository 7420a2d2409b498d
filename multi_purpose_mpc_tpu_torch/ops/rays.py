"""Fixed-length ray primitive over occupancy grids (port of ``ops/rays.py``).

Sample K evenly spaced points along a world-space segment and look up the
occupancy at each; K is fixed, so the op batches over any ray shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_purpose_mpc_tpu_torch.ops.grid import GridMap, lookup, w2m


class LineSamples(NamedTuple):
    occ: torch.Tensor  # (..., K) occupancy at each sample (1=free, 0=occupied/OOB)
    px: torch.Tensor  # (..., K) int32 pixel x
    py: torch.Tensor  # (..., K) int32 pixel y
    x: torch.Tensor  # (..., K) world x of each sample point
    y: torch.Tensor  # (..., K) world y of each sample point


def unit_linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n, dtype=float32)`` bit for bit: ``i / (n - 1)``
    for the first n - 1 points, then exactly 1."""
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


def sample_line(grid: GridMap, x0, y0, x1, y1, n_samples: int) -> LineSamples:
    """Sample ``n_samples`` points from (x0, y0) to (x1, y1) inclusive.

    Inputs broadcast; a trailing K axis is appended.  Out-of-bounds samples
    read as occupied.
    """
    t = unit_linspace(n_samples, grid.device)
    x = x0[..., None] + (x1 - x0)[..., None] * t
    y = y0[..., None] + (y1 - y0)[..., None] * t
    px, py = w2m(grid, x, y)
    occ = lookup(grid, px, py, oob_value=0.0)
    return LineSamples(occ=occ, px=px, py=py, x=x, y=y)


def first_occupied(samples: LineSamples):
    """``(hit, idx)``: any occupied sample, and the first occupied index
    along the last axis (K-1 when none)."""
    occupied = samples.occ < 0.5
    k = samples.occ.shape[-1]
    # argmax over bool returns the first True (0 if none), as jnp.argmax
    idx = torch.argmax(occupied.to(torch.uint8), dim=-1)
    hit = occupied.any(dim=-1)
    return hit, torch.where(hit, idx, torch.full_like(idx, k - 1))
