"""A LiDAR world built to give the ``cells`` sweep exact distance ties.

On a grid whose resolution is a power of two (1/64 m) and whose origin is
a multiple of it, every cell centre, every difference to a sensor at a
cell centre and every squared distance below are exact in float32.  Each
pose sits at the centre of a free cell (sx, sy) with yaw float32(pi / 4),
so the middle beam of a 360-degree, 4-degree scan (relative angle exactly
0) has ux = uy = float32(cos(pi / 4)); the two occupied cells (sx + 2,
sy + 1) and (sx + 1, sy + 2) lie at the same distance r * sqrt(5), their
perpendicular distances to that beam equal its support (u * r) exactly,
and both pass its corner-span test: a tie that only the smaller packed id
(the first cell) can break.  A few walls add cells that other beams hit.

Imports no JAX: ``tests/test_torch_scan_cells.py`` uses it on the CPU and
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""

import math
from types import SimpleNamespace

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.config import LidarConfig
from multi_purpose_mpc_tpu_torch.ops.grid import make_grid_map
from multi_purpose_mpc_tpu_torch.ops.lidar import (CellTable, cells_prologue,
                                                   occupied_cell_table,
                                                   waypoint_cell_table)
from multi_purpose_mpc_tpu_torch.utils.tree import tree_map

RES = 1.0 / 64
ORIGIN = (-1.0, -2.0)
SIZE = 160  # cells a side: 2.5 m
LIDAR = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=256)


def tie_world(device="cpu", lanes: int = 24):
    """``dict(grid, cells, wpc, wp_id, x, y, psi, cx, cy, ux, uy,
    support)`` on ``device``: the grid, its global boundary-cell table, a
    per-pose :class:`CellTable` (one row per pose: the cells within 1.25 m
    of it, by :func:`waypoint_cell_table`; each pose is its row's waypoint,
    so none falls back), ``lanes`` poses (pose i on row i) and
    the sweep's inputs for :data:`LIDAR` (:func:`cells_prologue`).  All is
    built on the CPU and then copied: on the card a division by a host
    scalar is a reciprocal multiply, which would move the middle beam off
    pi / 4."""
    occ = np.ones((SIZE, SIZE), np.float32)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 0.0  # the border
    occ[40:44, 100:130] = 0.0  # two walls
    occ[110:140, 30:33] = 0.0
    rng = np.random.default_rng(7)
    sensors = []
    while len(sensors) < lanes:
        sx, sy = (int(v) for v in rng.integers(8, SIZE - 12, 2))
        near = occ[sy - 3:sy + 6, sx - 3:sx + 6]
        if (near == 1.0).all() and all(abs(sx - a) + abs(sy - b) > 6
                                       for a, b in sensors):
            sensors.append((sx, sy))
    for sx, sy in sensors:
        occ[sy + 1, sx + 2] = occ[sy + 2, sx + 1] = 0.0
    grid = make_grid_map(occ, ORIGIN, RES, device="cpu")
    sx, sy = (np.array(v, np.float32) for v in zip(*sensors))
    x = (sx + np.float32(0.5)) * np.float32(RES) + np.float32(ORIGIN[0])
    y = (sy + np.float32(0.5)) * np.float32(RES) + np.float32(ORIGIN[1])
    cells = occupied_cell_table(grid.occ, pad_multiple=256)
    out = dict(grid=grid, cells=cells,
               wpc=CellTable(
                   waypoint_cell_table(cells, grid, SimpleNamespace(x=x, y=y),
                                       1.25, pad_multiple=256),
                   cells, torch.from_numpy(np.stack([x, y], -1)), 0.0),
               wp_id=torch.arange(lanes, dtype=torch.int32),
               x=torch.from_numpy(x), y=torch.from_numpy(y),
               psi=torch.full((lanes,), math.pi / 4, dtype=torch.float32))
    _, *inputs = cells_prologue(grid, out["x"], out["y"], out["psi"], LIDAR)
    out.update(zip(("cx", "cy", "ux", "uy", "support"), inputs))
    moved = {k: tree_map(lambda t: t.to(device), v) for k, v in out.items()
             if k != "grid"}
    moved["grid"] = make_grid_map(occ, ORIGIN, RES, device=device)
    return moved
