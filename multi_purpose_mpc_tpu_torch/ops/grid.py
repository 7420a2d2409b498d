"""Occupancy-grid map ops (port of ``multi_purpose_mpc_tpu/ops/grid.py``).

Conventions (identical to the JAX package and the reference):
  * ``occ[y, x]`` indexing, row = y pixel, col = x pixel;
  * 1 = free, 0 = occupied;
  * ``w2m``: world meters -> integer pixel via floor;
  * ``m2w``: pixel -> world coordinate of the cell center.

All arithmetic is float32 with the same operation order as the JAX
package, so pixel lookups agree bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class GridMap:
    """Occupancy grid + metadata on one device."""

    occ: torch.Tensor  # (H, W) float32, 1=free 0=occupied
    origin: torch.Tensor  # (2,) float32, world coords of pixel (0,0) corner
    resolution: torch.Tensor  # () float32, m/px

    @property
    def height(self) -> int:
        return self.occ.shape[0]

    @property
    def width(self) -> int:
        return self.occ.shape[1]

    @property
    def device(self) -> torch.device:
        return self.occ.device


def make_grid_map(occ, origin, resolution, device="cpu") -> GridMap:
    f32 = torch.float32
    return GridMap(occ=torch.as_tensor(occ, dtype=f32, device=device),
                   origin=torch.as_tensor(origin, dtype=f32, device=device),
                   resolution=torch.as_tensor(resolution, dtype=f32,
                                              device=device))


def w2m(grid: GridMap, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """World -> map pixel indices (floor convention), int32."""
    dx = torch.floor((x - grid.origin[0]) / grid.resolution)
    dy = torch.floor((y - grid.origin[1]) / grid.resolution)
    return dx.to(torch.int32), dy.to(torch.int32)


def m2w(grid: GridMap, dx, dy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map pixel -> world coordinates of the cell center."""
    x = (dx.to(torch.float32) + 0.5) * grid.resolution + grid.origin[0]
    y = (dy.to(torch.float32) + 0.5) * grid.resolution + grid.origin[1]
    return x, y


def lookup(grid: GridMap, px: torch.Tensor, py: torch.Tensor,
           oob_value: float = 0.0) -> torch.Tensor:
    """Occupancy at integer pixel coords; out-of-bounds reads ``oob_value``."""
    h, w = grid.occ.shape
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    vals = grid.occ[py.clamp(0, h - 1).long(), px.clamp(0, w - 1).long()]
    return torch.where(inb, vals, torch.full_like(vals, oob_value))


def rasterize_disks_px(grid: GridMap, px, py, r_px, active=None) -> GridMap:
    """Rasterize pixel-space disks into a new grid (reference: map.py:129-137).

    Same integer-pixel convention as the JAX package: offsets in
    ``[-r, r-1]`` and the circle test ``offx^2 + offy^2 <= r^2``, so masks
    match bit for bit given the same center pixels.
    """
    dev = grid.device
    px = torch.as_tensor(px, dtype=torch.int32, device=dev).reshape(-1)
    py = torch.as_tensor(py, dtype=torch.int32, device=dev).reshape(-1)
    r_px = torch.as_tensor(r_px, dtype=torch.int32, device=dev).reshape(-1)
    if active is None:
        active = torch.ones(px.shape, dtype=torch.bool, device=dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev).reshape(-1)

    h, w = grid.occ.shape
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    covered = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for k in range(px.shape[0]):  # a handful of disks: loop, no (K, H, W)
        offx = xs - px[k]
        offy = ys - py[k]
        r = r_px[k]
        in_window = (offx >= -r) & (offx < r) & (offy >= -r) & (offy < r)
        in_disk = (offx * offx + offy * offy) <= r * r
        covered |= in_window & in_disk & active[k]
    occ = torch.where(covered, torch.zeros_like(grid.occ), grid.occ)
    return dataclasses.replace(grid, occ=occ)


def add_obstacles(grid: GridMap, cx, cy, radius, active=None) -> GridMap:
    """Rasterize circular world-space obstacles with float32 pixel math.

    For bit-exact setup-time parity with the reference use
    :func:`...utils.maps.add_obstacles_host` (float64 center pixels).
    """
    dev = grid.device
    f32 = torch.float32
    cx = torch.as_tensor(cx, dtype=f32, device=dev).reshape(-1)
    cy = torch.as_tensor(cy, dtype=f32, device=dev).reshape(-1)
    radius = torch.as_tensor(radius, dtype=f32, device=dev).reshape(-1)
    r_px = torch.ceil(radius / grid.resolution).to(torch.int32)
    px, py = w2m(grid, cx, cy)
    return rasterize_disks_px(grid, px, py, r_px, active)
