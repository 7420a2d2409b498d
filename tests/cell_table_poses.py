"""Poses that hold the ``cells`` scan's pruned table (``ops/lidar.CellTable``)
to the global table on Sim_Track, near their waypoints and past the slack.

* :func:`off_track`: a sensor 0.293 m from its lane's waypoint (the
  offset of a fleet lane off the track whose scan missed a hit through the
  waypoint's row alone), stepped toward a boundary cell just past the
  row's radius, with one beam aimed at that cell: the row lacks cells in
  the scan's range, so only a fallback to the global table finds them.
* :func:`on_track`: the free cell farthest from its nearest waypoint, the
  farthest pose the track allows, on that waypoint's row and on the row
  before (a lane's waypoint lags its pose by up to a step), and poses
  drawn near random waypoints; all within the table's reach.

Imports no JAX: ``tests/test_torch_cell_table.py`` uses it on the CPU and
``tests/test_torch_cuda.py`` on the card.
"""

import math
import os

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.config import LidarConfig, sim_track_preset
from multi_purpose_mpc_tpu_torch.ops.grid import m2w
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.utils.maps import (add_obstacles_host,
                                                    load_grid_map)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "maps")
LIDAR = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
ONE_BEAM = LidarConfig(FoV=0, range=1.0, resolution=4, n_ray_samples=192)
OFF_TRACK_M = 0.293


def sim_track():
    """``(grid, path)`` of Sim_Track with its obstacles, on the CPU."""
    map_cfg, path_cfg, *_, obstacles = sim_track_preset(ASSETS)
    grid = load_grid_map(map_cfg, device="cpu")
    path = build_reference_path(grid, path_cfg)
    return add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles), path


def _cell_centres(grid, cells):
    real = cells[:, 0] > -(10 ** 5)
    x, y = m2w(grid, cells[real, 0], cells[real, 1])
    return torch.stack([x, y], -1)


def off_track(grid, path, radius: float, waypoints=range(10)):
    """``(x, y, psi, wp_id)`` float32 / int32: for each of ``waypoints``
    and each boundary cell within 1.2 cm past ``radius`` of it, the pose
    :data:`OFF_TRACK_M` from the waypoint toward the cell, heading at it
    (:data:`ONE_BEAM`'s beam)."""
    from multi_purpose_mpc_tpu_torch.ops.lidar import occupied_cell_table

    cells = _cell_centres(grid, occupied_cell_table(grid.occ))
    wps = torch.stack([path.x, path.y], -1)
    xs, ys, ps, ws = [], [], [], []
    for w in waypoints:
        d = torch.linalg.norm(cells - wps[w], dim=-1)
        for i in torch.nonzero((d >= radius) & (d < radius + 0.012))[:, 0]:
            u = (cells[i] - wps[w]) / d[i]
            p = wps[w] + OFF_TRACK_M * u
            xs.append(float(p[0]))
            ys.append(float(p[1]))
            ps.append(math.atan2(float(cells[i, 1] - p[1]),
                                 float(cells[i, 0] - p[0])))
            ws.append(w)
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    return f(xs), f(ys), f(ps), torch.tensor(ws, dtype=torch.int32)


def on_track(grid, path, lanes: int = 24, seed: int = 0):
    """``(x, y, psi, wp_id)``: the free cell farthest from its nearest
    waypoint, on that waypoint and on the one before, then ``lanes`` poses
    up to 6 cm off random waypoints, each on its nearest waypoint."""
    fy, fx = torch.nonzero(grid.occ > 0.5, as_tuple=True)
    free = torch.stack(m2w(grid, fx.int(), fy.int()), -1)
    wps = torch.stack([path.x, path.y], -1)
    near, wn = torch.cdist(free, wps).min(1)
    far = int(torch.argmax(near))
    rng = np.random.default_rng(seed)
    w = rng.integers(0, path.n_wp, lanes)
    pts = wps[w] + torch.tensor(rng.uniform(-0.06, 0.06, (lanes, 2)),
                                dtype=torch.float32)
    pts = torch.cat([free[far][None].expand(2, 2), pts])
    wp = torch.cdist(pts, wps).argmin(1).int()
    wp[1] = (wp[0] - 1) % path.n_wp
    psi = torch.tensor(rng.uniform(-np.pi, np.pi, lanes + 2),
                       dtype=torch.float32)
    return pts[:, 0].contiguous(), pts[:, 1].contiguous(), psi, wp
