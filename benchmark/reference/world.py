"""The plain reference's world: the map, the reference path, its static
corridor borders and its speed profile, re-derived from the raw map image
and the configuration's numbers, in float64.

The upstream semantics (matssteinweg/Multi-Purpose-MPC: map.py,
reference_path.py) as the controller under test states them:

* map: red channel >= threshold is free (1), else occupied (0); occupied
  speckles under ``hole_area_threshold`` pixels (8-connected) are filled;
  obstacles are integer-pixel disks, offsets in [-r, r-1] and
  off_x^2 + off_y^2 <= r^2;
* path: corner points densified per segment (endpoint excluded, goal
  appended), a +-smoothing_distance moving average, heading from the
  look-ahead difference, curvature the wrapped heading change over the
  look-ahead distance (0 at the first waypoint), the last point dropped;
* static borders: per side, 9 rays of ``n_ray_samples`` samples from the
  waypoint to the 3 x 3 cells around the point ``max_width`` away along the
  normal; the nearest first-occupied cell centre (out of the image reads
  occupied), else the target point;
* speed profile: min sum 1/2 v^2 - vmax_i v under the acceleration and
  curvature limits, solved to convergence (:mod:`.qp`).

Where the configuration turns a coordinate into a pixel index, the
coordinate is formed in float32, as the configuration states its
arithmetic; everything else is float64.  Imports neither JAX nor the
program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from PIL import Image
from scipy import ndimage

from benchmark.reference import qp as qp_ref

F64 = torch.float64
F32 = torch.float32


@dataclasses.dataclass
class World:
    """Map and path of one configuration, float64 tensors on ``device``."""

    occ: torch.Tensor  # (H, W) float64, 1 free, 0 occupied (obstacles in)
    origin: tuple
    res: float
    x: torch.Tensor  # (n,) path
    y: torch.Tensor
    psi: torch.Tensor
    kappa: torch.Tensor
    v_ref: torch.Tensor
    border_ub: torch.Tensor  # (n, 2)
    border_lb: torch.Tensor
    cum_len: torch.Tensor
    seg_dist: torch.Tensor
    length: float
    circular: bool

    @property
    def n_wp(self) -> int:
        return self.x.shape[0]


def load_map(file_path: str, threshold: int, hole_area: int) -> np.ndarray:
    raw = np.array(Image.open(file_path))
    if raw.ndim == 3:
        raw = raw[:, :, 0]
    free = (raw >= threshold).astype(np.int8)
    labels, n = ndimage.label(free == 0, structure=np.ones((3, 3), bool))
    if n:
        sizes = np.bincount(labels.ravel(), minlength=n + 1)
        small = sizes < hole_area
        small[0] = False
        free[small[labels]] = 1
    return free


def add_disks(free: np.ndarray, origin, res: float, obstacles) -> np.ndarray:
    out = free.copy()
    h, w = out.shape
    ys, xs = np.mgrid[0:h, 0:w]
    for cx, cy, r in obstacles:
        px = int(np.floor((cx - origin[0]) / res))
        py = int(np.floor((cy - origin[1]) / res))
        rp = int(np.ceil(r / res))
        ox, oy = xs - px, ys - py
        disk = ((ox >= -rp) & (ox < rp) & (oy >= -rp) & (oy < rp)
                & (ox * ox + oy * oy <= rp * rp))
        out[disk] = 0
    return out


def path_geometry(wp_x, wp_y, resolution: float, smoothing: int):
    """Waypoints (x, y, psi, kappa), float64 numpy."""
    xs, ys = [], []
    for i in range(len(wp_x) - 1):
        n = int(math.hypot(wp_x[i + 1] - wp_x[i], wp_y[i + 1] - wp_y[i])
                / resolution)
        xs.append(np.linspace(wp_x[i], wp_x[i + 1], n, endpoint=False))
        ys.append(np.linspace(wp_y[i], wp_y[i + 1], n, endpoint=False))
    gx = np.concatenate(xs + [np.asarray(wp_x[-1:], np.float64)])
    gy = np.concatenate(ys + [np.asarray(wp_y[-1:], np.float64)])
    if smoothing > 0:
        k = np.ones(2 * smoothing + 1) / (2 * smoothing + 1)
        gx, gy = np.convolve(gx, k, "valid"), np.convolve(gy, k, "valid")
    dx, dy = np.diff(gx), np.diff(gy)
    psi = np.arctan2(dy, dx)
    dist = np.hypot(dx, dy)
    dpsi = np.mod(psi[1:] - psi[:-1] + np.pi, 2 * np.pi) - np.pi
    kappa = np.concatenate([[0.0], dpsi / (dist[1:] + 1e-12)])
    return gx[:-1], gy[:-1], psi, kappa


def pixel(origin, res: float, x: torch.Tensor, y: torch.Tensor):
    """float32 world coordinates -> int64 pixel indices (floor)."""
    o = torch.tensor(origin, dtype=F32, device=x.device)
    r = torch.tensor(res, dtype=F32, device=x.device)
    return (torch.floor((x - o[0]) / r).long(),
            torch.floor((y - o[1]) / r).long())


def centre(origin, res: float, px: torch.Tensor, py: torch.Tensor):
    """Pixel -> float64 world cell centre."""
    return ((px.to(F64) + 0.5) * res + origin[0],
            (py.to(F64) + 0.5) * res + origin[1])


def unit_t(n: int, device) -> torch.Tensor:
    """n float32 sample fractions from 0 to 1, both ends exact."""
    t = torch.arange(n - 1, dtype=F32, device=device) / float(n - 1)
    return torch.cat([t, torch.ones(1, dtype=F32, device=device)])


def read_occ(occ: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """occ at integer pixels; out of the image reads occupied (0)."""
    h, w = occ.shape[-2:]
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    v = occ[..., py.clamp(0, h - 1), px.clamp(0, w - 1)] if occ.dim() == 2 \
        else None
    return torch.where(inb, v, torch.zeros_like(v))


def line_samples(p0: torch.Tensor, p1: torch.Tensor, n: int, origin, res):
    """Pixels of ``n`` float32 samples from p0 to p1 (..., 2)."""
    a, b = p0.to(F32), p1.to(F32)
    t = unit_t(n, p0.device)
    x = a[..., 0:1] + (b[..., 0:1] - a[..., 0:1]) * t
    y = a[..., 1:2] + (b[..., 1:2] - a[..., 1:2]) * t
    return pixel(origin, res, x, y)


def centre32(origin, res: float, px: torch.Tensor, py: torch.Tensor):
    """Pixel -> float32 world cell centre, as the configuration forms it."""
    o = torch.tensor(origin, dtype=F32, device=px.device)
    r = torch.tensor(res, dtype=F32, device=px.device)
    return (px.to(F32) + 0.5) * r + o[0], (py.to(F32) + 0.5) * r + o[1]


def static_borders(occ, origin, res, x, y, psi, max_width: float,
                   n_samples: int):
    """(border_ub, border_lb) (n, 2): a choice among cells, made in the
    configuration's float32 throughout."""
    off = torch.arange(-1, 2, device=x.device)
    ox = off[:, None].expand(3, 3).reshape(-1)
    oy = off[None, :].expand(3, 3).reshape(-1)
    x32, y32, psi32 = x.to(F32), y.to(F32), psi.to(F32)
    out = []
    for sign in (1.0, -1.0):
        ang = torch.remainder(psi32 + sign * (math.pi / 2) + math.pi,
                              2 * math.pi) - math.pi
        tx = x32 + max_width * torch.cos(ang)
        ty = y32 + max_width * torch.sin(ang)
        tpx, tpy = pixel(origin, res, tx, ty)
        cx, cy = centre32(origin, res, tpx[:, None] + ox, tpy[:, None] + oy)
        p0 = torch.stack([x32, y32], -1)[:, None].expand(-1, 9, 2)
        px, py = line_samples(p0, torch.stack([cx, cy], -1), n_samples,
                              origin, res)
        occupied = read_occ(occ, px, py) < 0.5
        hit = occupied.any(-1)
        first = torch.argmax(occupied.to(torch.uint8), -1)
        first = torch.where(hit, first, torch.full_like(first, n_samples - 1))
        hx, hy = centre32(origin, res, px.gather(-1, first[..., None])[..., 0],
                          py.gather(-1, first[..., None])[..., 0])
        d = torch.hypot(x32[:, None] - hx, y32[:, None] - hy)
        d = torch.where(hit, d, torch.full_like(d, math.inf))
        best = torch.argmin(d, -1, keepdim=True)
        d_best = d.gather(-1, best)[:, 0]
        any_hit = hit.any(-1) & (d_best < max_width)
        bx = torch.where(any_hit, hx.gather(-1, best)[:, 0], tx)
        by = torch.where(any_hit, hy.gather(-1, best)[:, 0], ty)
        out.append(torch.stack([bx, by], -1).to(F64))
    return out[0], out[1]


def speed_profile(kappa: np.ndarray, seg_dist: np.ndarray, c: dict):
    """v_ref (n,) of the curvature-limited speed profile QP, converged."""
    n = kappa.shape[0] - 1
    vmax = np.minimum(np.sqrt(c["ay_max"] / (np.abs(kappa[:n]) + 1e-12)),
                      c["v_max"])
    li = seg_dist[:n]
    rows = np.arange(n - 1)
    D = np.zeros((n - 1, n))
    D[rows, rows] = -1.0 / (2.0 * li[:-1])
    D[rows, rows + 1] = 1.0 / (2.0 * li[:-1])
    v = qp_ref.solve_dense(np.eye(n), -vmax, D, np.full(n - 1, c["a_min"]),
                           np.full(n - 1, c["a_max"]),
                           np.full(n, c["v_min"]), vmax)
    return np.concatenate([v, v[-1:]])


def build_world(cfg: dict, root: str, device) -> World:
    """The configuration's world from its raw map image and numbers."""
    m, p = cfg["map"], cfg["path"]
    free = load_map(f"{root}/{m['file']}", m["threshold_occupied"],
                    m["hole_area_threshold"])
    origin, res = tuple(m["origin"]), float(m["resolution"])
    gx, gy, psi, kappa = path_geometry(p["wp_x"], p["wp_y"], p["resolution"],
                                       p["smoothing_distance"])
    d = np.hypot(np.diff(gx), np.diff(gy))
    cum = np.concatenate([[0.0], np.cumsum(d)])
    if p["circular"]:
        seg = np.concatenate([d, [math.hypot(gx[0] - gx[-1], gy[0] - gy[-1])]])
    else:
        seg = np.concatenate([d, [d[-1]]])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    x, y, psit = t(gx), t(gy), t(psi)
    # the borders are found on the map before the obstacles (upstream's
    # order: the path is built, then obstacles are added)
    bub, blb = static_borders(t(free), origin, res, x, y, psit,
                              p["max_width"], p["n_ray_samples"])
    occ = add_disks(free, origin, res, cfg.get("obstacles", ()))
    v_ref = speed_profile(kappa, seg, cfg["speed"])
    return World(occ=t(occ), origin=origin, res=res, x=x, y=y, psi=psit,
                 kappa=t(kappa), v_ref=t(v_ref), border_ub=bub, border_lb=blb,
                 cum_len=t(cum), seg_dist=t(seg), length=float(cum[-1]),
                 circular=bool(p["circular"]))


def wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def horizon_index(w: World, wp: torch.Tensor, offs: torch.Tensor):
    i = wp[..., None] + offs
    return torch.remainder(i, w.n_wp) if w.circular else i.clamp(0, w.n_wp - 1)


def locate(w: World, s: torch.Tensor) -> torch.Tensor:
    """Nearest waypoint by arc length: the closer of the two enclosing
    ``s`` (circular paths wrap at the last waypoint's arc length).  A
    choice among waypoints, made in the configuration's float32."""
    s = s.to(F32)
    cum = w.cum_len.to(F32)
    if w.circular:
        s = torch.remainder(s, torch.tensor(w.length, dtype=F32,
                                            device=s.device))
    nxt = torch.searchsorted(cum, s, right=True).clamp(1, w.n_wp - 1)
    prv = nxt - 1
    closer = (s - cum[nxt]).abs() < (s - cum[prv]).abs()
    return torch.where(closer, nxt, prv)


def spatial(w: World, wp, x, y, psi):
    """(e_y, e_psi) of world poses relative to waypoint ``wp``."""
    wx, wy, wpsi = w.x[wp], w.y[wp], w.psi[wp]
    e_y = torch.cos(wpsi) * (y - wy) - torch.sin(wpsi) * (x - wx)
    return e_y, wrap(psi - wpsi)


def plant(w: World, length: float, Ts: float, x, y, psi, s, v, delta):
    """One forward-Euler step of the kinematic bicycle; progress integrates
    v cos(e_psi) / (1 - e_y kappa) at the located waypoint."""
    wp = locate(w, s)
    e_y, e_psi = spatial(w, wp, x, y, psi)
    s_dot = v * torch.cos(e_psi) / (1.0 - e_y * w.kappa[wp])
    return (x + v * torch.cos(psi) * Ts, y + v * torch.sin(psi) * Ts,
            psi + v / length * torch.tan(delta) * Ts, s + s_dot * Ts)
