"""Reference-path geometry as struct-of-arrays (port of ``ops/path.py``).

Construction from corner points is host-side float64 numpy (identical to
the JAX package); the static drivable width is a batched ray march over
the occupancy grid on the grid's device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.config import PathConfig
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap, m2w, w2m
from multi_purpose_mpc_tpu_torch.ops.rays import first_occupied, sample_line

EPS = 1e-12


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] — floor-mod like ``jnp.mod`` (never ``fmod``)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def wrap_angle_np(a):
    return np.mod(a + np.pi, 2.0 * np.pi) - np.pi


@dataclasses.dataclass(eq=False)
class PathData:
    """Struct-of-arrays reference path (one tensor per waypoint attribute).

    Compared and hashed by identity, so that per-path tables can be cached
    against it (:func:`~.constraints.update_path_constraints`)."""

    x: torch.Tensor  # (n,) world x
    y: torch.Tensor  # (n,) world y
    psi: torch.Tensor  # (n,) heading
    kappa: torch.Tensor  # (n,) curvature
    v_ref: torch.Tensor  # (n,) speed-profile reference velocity
    lb: torch.Tensor  # (n,) static lower (right) drivable bound, <= 0
    ub: torch.Tensor  # (n,) static upper (left) drivable bound, >= 0
    border_ub: torch.Tensor  # (n, 2) world coords of left border point
    border_lb: torch.Tensor  # (n, 2) world coords of right border point
    seg_len: torch.Tensor  # (n,) [0, d(0,1), ..., d(n-2,n-1)]
    cum_len: torch.Tensor  # (n,) cumulative seg_len
    seg_dist: torch.Tensor  # (n,) d(i, i+1) with wrap/clamp
    length: torch.Tensor  # () total center-line length
    circular: bool = False

    @property
    def n_wp(self) -> int:
        return self.x.shape[0]


def densify_and_smooth(wp_x, wp_y, resolution: float, smoothing_distance: int):
    """Corner points -> dense smoothed center line (reference_path.py:110-146)."""
    wp_x = np.asarray(wp_x, np.float64)
    wp_y = np.asarray(wp_y, np.float64)
    seg_d = np.hypot(np.diff(wp_x), np.diff(wp_y))
    n_wp = (seg_d / resolution).astype(int)

    xs = [np.linspace(wp_x[i], wp_x[i + 1], n_wp[i], endpoint=False) for i in range(len(wp_x) - 1)]
    ys = [np.linspace(wp_y[i], wp_y[i + 1], n_wp[i], endpoint=False) for i in range(len(wp_y) - 1)]
    gx = np.concatenate(xs + [wp_x[-1:]])
    gy = np.concatenate(ys + [wp_y[-1:]])

    sd = smoothing_distance
    if sd > 0:
        win = 2 * sd + 1
        kernel = np.ones(win) / win
        gx = np.convolve(gx, kernel, mode="valid")
        gy = np.convolve(gy, kernel, mode="valid")
    return gx, gy


def headings_and_curvature(gx: np.ndarray, gy: np.ndarray):
    """Per-waypoint psi / kappa (reference_path.py:148-193)."""
    dx = np.diff(gx)
    dy = np.diff(gy)
    psi = np.arctan2(dy, dx)
    dist_ahead = np.hypot(dx, dy)
    dpsi = wrap_angle_np(psi[1:] - psi[:-1])
    kappa = np.concatenate([[0.0], dpsi / (dist_ahead[1:] + EPS)])
    return gx[:-1], gy[:-1], psi, kappa


def path_lengths(x: np.ndarray, y: np.ndarray, circular: bool):
    """seg_len / cum_len / seg_dist / total length (reference_path.py:195-204)."""
    d = np.hypot(np.diff(x), np.diff(y))
    seg_len = np.concatenate([[0.0], d])
    cum_len = np.cumsum(seg_len)
    if circular:
        seam = math.hypot(x[0] - x[-1], y[0] - y[-1])
        seg_dist = np.concatenate([d, [seam]])
    else:
        seg_dist = np.concatenate([d, [d[-1]]])
    return seg_len, cum_len, seg_dist, float(cum_len[-1])


def compute_static_width(grid: GridMap, x, y, psi, max_width: float,
                         n_ray_samples: int = 128):
    """Static drivable width left/right of the center line (batched over
    waypoints): for each side, march 9 rays toward the 3x3 pixel
    neighbourhood of the point ``max_width`` away along the normal and take
    the nearest first-occupied cell center.

    Returns ``(ub, lb, border_ub, border_lb)`` with ``lb = -right_width``.
    """
    dev = grid.device
    offs = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    ox = offs[:, None].expand(3, 3).reshape(-1)  # meshgrid(..., indexing="ij")
    oy = offs[None, :].expand(3, 3).reshape(-1)

    def side_width(side_sign: float):
        angle = wrap_angle(psi + side_sign * (math.pi / 2.0))
        tx = x + max_width * torch.cos(angle)
        ty = y + max_width * torch.sin(angle)
        tpx, tpy = w2m(grid, tx, ty)
        ntx, nty = m2w(grid, tpx[:, None] + ox, tpy[:, None] + oy)  # (n, 9)
        s = sample_line(grid, x[:, None], y[:, None], ntx, nty, n_ray_samples)
        hit, idx = first_occupied(s)  # (n, 9)
        hx, hy = m2w(grid,
                     torch.gather(s.px, -1, idx[..., None])[..., 0],
                     torch.gather(s.py, -1, idx[..., None])[..., 0])
        d = torch.hypot(x[:, None] - hx, y[:, None] - hy)
        d = torch.where(hit, d, torch.full_like(d, math.inf))
        best = torch.argmin(d, dim=-1, keepdim=True)
        d_best = torch.gather(d, -1, best)[:, 0]
        width = torch.clamp(d_best, max=max_width)
        any_hit = hit.any(dim=-1) & (d_best < max_width)
        bx = torch.where(any_hit, torch.gather(hx, -1, best)[:, 0], tx)
        by = torch.where(any_hit, torch.gather(hy, -1, best)[:, 0], ty)
        return width, bx, by

    ub, ubx, uby = side_width(+1.0)
    rw, lbx, lby = side_width(-1.0)
    return ub, -rw, torch.stack([ubx, uby], -1), torch.stack([lbx, lby], -1)


def build_reference_path(grid: GridMap, cfg: PathConfig) -> PathData:
    """Corner points -> PathData with static bounds, on the grid's device.

    ``v_ref`` is zero until :func:`...ops.speed_profile.compute_speed_profile`
    fills it.
    """
    gx, gy = densify_and_smooth(cfg.wp_x, cfg.wp_y, cfg.resolution, cfg.smoothing_distance)
    px, py, psi, kappa = headings_and_curvature(gx, gy)
    seg_len, cum_len, seg_dist, length = path_lengths(px, py, cfg.circular)

    dev = grid.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    xt, yt, psit = f32(px), f32(py), f32(psi)
    ub, lb, border_ub, border_lb = compute_static_width(
        grid, xt, yt, psit, cfg.max_width, cfg.n_ray_samples)
    return PathData(x=xt, y=yt, psi=psit, kappa=f32(kappa),
                    v_ref=torch.zeros_like(xt), lb=lb, ub=ub,
                    border_ub=border_ub, border_lb=border_lb,
                    seg_len=f32(seg_len), cum_len=f32(cum_len),
                    seg_dist=f32(seg_dist), length=f32(length),
                    circular=cfg.circular)


def w2m_pair(grid: GridMap, x, y):
    px, py = w2m(grid, x, y)
    return px, py


def gather_waypoint_index(path: PathData, wp_id, offset):
    """Horizon index resolution: circular wrap or end-of-path clamp."""
    idx = wp_id + offset
    n = path.n_wp
    if path.circular:
        return torch.remainder(idx, n)
    return torch.clamp(idx, 0, n - 1)
