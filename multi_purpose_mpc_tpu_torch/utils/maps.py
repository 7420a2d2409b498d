"""Host-side occupancy-map loading (port of ``utils/maps.py``, numpy path).

Image decode and speckle cleanup run once on the host (numpy + PIL +
scipy.ndimage); the result is uploaded as a :class:`GridMap`.  The JAX
package's optional native C pipeline is pinned equal to this numpy path by
its own tests, so the port keeps only the numpy path.
"""

from __future__ import annotations

import numpy as np
from PIL import Image
from scipy import ndimage

from multi_purpose_mpc_tpu_torch.config import MapConfig
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap, make_grid_map, rasterize_disks_px


def binarize(img: np.ndarray, threshold_occupied: int = 100) -> np.ndarray:
    """Binarize the red channel: 1 = free, 0 = occupied (reference: map.py:110)."""
    return np.where(img >= threshold_occupied, 1, 0).astype(np.int8)


def remove_small_holes(binary: np.ndarray, area_threshold: int = 5) -> np.ndarray:
    """Fill occupied speckles with area < ``area_threshold`` px
    (8-connectivity), like ``skimage.morphology.remove_small_holes``."""
    holes = binary == 0
    structure = np.ones((3, 3), dtype=bool)
    labels, n = ndimage.label(holes, structure=structure)
    if n == 0:
        return binary
    sizes = ndimage.sum_labels(np.ones_like(labels), labels, index=np.arange(1, n + 1))
    small = np.concatenate([[False], sizes < area_threshold])
    out = binary.copy()
    out[small[labels]] = 1
    return out


def load_map_image(file_path: str, threshold_occupied: int = 100,
                   hole_area_threshold: int = 5) -> np.ndarray:
    """PNG -> clean binary occupancy array (1=free, 0=occupied)."""
    raw = np.array(Image.open(file_path))
    if raw.ndim == 3:
        raw = raw[:, :, 0]
    binary = binarize(raw, threshold_occupied)
    return remove_small_holes(binary, hole_area_threshold)


def obstacle_pixels(origin, resolution: float, cx, cy, radius):
    """Float64 world->pixel conversion for obstacle rasterization (matches
    the reference's float64 ``w2m`` + ``ceil``, map.py:85-86, 129)."""
    cx = np.asarray(cx, np.float64)
    cy = np.asarray(cy, np.float64)
    radius = np.asarray(radius, np.float64)
    px = np.floor((cx - origin[0]) / resolution).astype(np.int32)
    py = np.floor((cy - origin[1]) / resolution).astype(np.int32)
    r_px = np.ceil(radius / resolution).astype(np.int32)
    return px, py, r_px


def add_obstacles_host(grid: GridMap, origin, resolution: float,
                       obstacles) -> GridMap:
    """Rasterize ``(cx, cy, radius)`` obstacles with float64 pixel math."""
    obs = np.asarray(obstacles, np.float64).reshape(-1, 3)
    px, py, r_px = obstacle_pixels(origin, resolution, obs[:, 0], obs[:, 1], obs[:, 2])
    return rasterize_disks_px(grid, px, py, r_px)


def load_grid_map(cfg: MapConfig, device="cuda") -> GridMap:
    """Load a :class:`GridMap` from a :class:`MapConfig` onto ``device`` (the
    card unless the caller names another device)."""
    data = load_map_image(cfg.file_path, cfg.threshold_occupied, cfg.hole_area_threshold)
    return make_grid_map(data.astype(np.float32), cfg.origin, cfg.resolution,
                         device=device)
