"""LiDAR sensor model and online map write-back (port of
``multi_purpose_mpc_tpu/ops/lidar.py``).

Semantics kept from the JAX package and the reference (lidar_model.py):

* beam angles span ``[-FoV/2, +FoV/2]`` degrees around the car's yaw;
* the sensor sits at the centre of the car's cell;
* a hit range is the distance to the hit cell's centre; misses keep the
  maximum range.

Scans (every function takes a fleet: poses (B,), outputs (B, n_beams)):

* ``march`` (:func:`scan`, ``conservative=False``): the first occupied cell
  among K point samples along each beam;
* ``conservative`` (:func:`scan`, ``conservative=True``): the reference's
  exact corner-span test over the 3 x 3 neighbourhood of every sample;
* ``cells`` (:func:`scan_fleet`): the same corner-span test swept over a
  static table of occupied boundary cells (:func:`occupied_cell_table`,
  optionally pruned per waypoint by :func:`waypoint_cell_table`), chunked
  over lanes and cells so that no intermediate passes ``max_elems``
  elements.  Plain PyTorch (it is XLA code in the JAX package, not a
  Pallas kernel).

Beam directions take cos/sin in float64, rounded once to float32, so a
scan is the same on every device whatever its float32 trig approximation;
against the JAX package's float32 trig a beam can then end one cell apart
on a grazing hit (the tests state the bar).

Map write-back (1 = free, 0 = occupied; observed-free clearing first, hits
after, so an observed obstacle always wins):

* :func:`update_grid_from_scan` / :func:`scatter_writeback_` — scatter
  min/max, the JAX package's ``.at[].min/.max``;
* :func:`fleet_observation_masks` + :func:`apply_observation_masks`
  (:func:`fleet_writeback`) — dense hit / free masks, built with
  ``index_put_`` of constants.  The JAX package builds them as bf16
  one-hot matmuls, a TPU device standing in for scatter; the masks are the
  same.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from multi_purpose_mpc_tpu_torch.config import LidarConfig
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap, lookup, m2w, w2m
from multi_purpose_mpc_tpu_torch.ops.rays import (first_occupied, sample_line,
                                                unit_linspace)

_F32 = torch.float32
_BIG = 1e9
_DUMMY = -(10 ** 6)  # pixel coordinate of a padding row in the cell tables


class LidarScan(NamedTuple):
    angles: torch.Tensor  # (..., n_beams) beam angles relative to the yaw [rad]
    ranges: torch.Tensor  # (..., n_beams) measured range [m] (max range on a miss)
    hit: torch.Tensor  # (..., n_beams) bool: the beam hit an obstacle
    hit_xy: torch.Tensor  # (..., n_beams, 2) world coords of the hit cell centres


def linspace_f32(start: float, stop: float, n: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, n, dtype=float32)``'s formula: ``start *
    (1 - t) + stop * t`` with ``t = i / (n - 1)``, ending exactly at
    ``stop``.  The end points are filled on the device, with no copy from
    the host (a step that scans runs under CUDA-graph capture)."""
    s = torch.full((), start, dtype=_F32, device=device)
    if n == 1:
        return s[None]
    t = unit_linspace(n, device)
    return s * (1 - t) + torch.full((), stop, dtype=_F32, device=device) * t


def beam_angles(cfg: LidarConfig, device="cuda") -> torch.Tensor:
    """Relative beam angles (reference: lidar_model.py:31-33)."""
    half = math.pi / 360.0 * cfg.FoV
    return linspace_f32(-half, half, cfg.n_beams, device)


def _unit(angle: torch.Tensor):
    """cos/sin of float32 angles, taken in float64 and rounded once."""
    a = angle.double()
    return torch.cos(a).to(_F32), torch.sin(a).to(_F32)


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula, ``a * sqrt(1 + (b / a)^2)`` with a = max,
    b = min, so that ranges follow the JAX package's (up to the FMAs
    XLA:CPU contracts it into)."""
    x, y = x.abs(), y.abs()
    a, b = torch.maximum(x, y), torch.minimum(x, y)
    zero = a == 0
    r = a * torch.sqrt(1 + torch.square(b / torch.where(zero, torch.ones_like(a), a)))
    r = torch.where(zero, a, r)
    return torch.where(torch.isposinf(x) | torch.isposinf(y),
                       torch.full_like(r, math.inf), r)


def _sensor(grid: GridMap, x, y):
    """Sensor position: the centre of the car's cell (lidar_model.py:54-56)."""
    px, py = w2m(grid, x, y)
    return m2w(grid, px, py)


def scan(grid: GridMap, x, y, psi, cfg: LidarConfig,
         conservative: bool = False) -> LidarScan:
    """Scans from poses ``(x, y, psi)`` — each (B,) for a fleet, or 0-d
    for one car (outputs then lose their batch axis).

    ``conservative=False``: the first occupied cell among ``n_ray_samples``
    point samples along each beam.  ``conservative=True``: the reference's
    corner-span semantics — beam b is updated by occupied cell c iff the
    beam's ray intersects c's square, i.e. ``perp_dist(centre(c), ray) <=
    (|n_x| + |n_y|) / 2 * resolution``, tested over the 3 x 3 neighbourhood
    of every sample (exact when the sample spacing is below one cell:
    :meth:`LidarConfig.validate_for_grid`)."""
    if conservative:
        cfg.validate_for_grid(float(grid.resolution))
    return scan_rays(grid, x, y, psi, cfg, conservative)


def scan_rays(grid: GridMap, x, y, psi, cfg: LidarConfig,
              conservative: bool = False) -> LidarScan:
    """:func:`scan` without its check of the sampling against the grid,
    which reads the resolution back to the host: for a caller that checked
    it before, as a scan captured in a CUDA graph must."""
    x, y, psi = (torch.as_tensor(v, dtype=_F32, device=grid.device)
                 for v in (x, y, psi))
    angles = beam_angles(cfg, grid.device)
    cx, cy = _sensor(grid, x, y)
    cxb, cyb = cx[..., None], cy[..., None]
    world_ang = angles + psi[..., None]
    ux, uy = _unit(world_ang)
    ex = cxb + cfg.range * ux
    ey = cyb + cfg.range * uy
    samples = sample_line(grid, cxb.expand_as(ex), cyb.expand_as(ey), ex, ey,
                          cfg.n_ray_samples)
    angles = angles.expand_as(world_ang)

    if not conservative:
        hit, idx = first_occupied(samples)
        hpx = torch.take_along_dim(samples.px, idx[..., None], -1)[..., 0]
        hpy = torch.take_along_dim(samples.py, idx[..., None], -1)[..., 0]
        hx, hy = m2w(grid, hpx, hpy)
        dist = _hypot(hx - cxb, hy - cyb)
        rng = torch.full_like(dist, cfg.range)
        ranges = torch.where(hit, dist.clamp(max=cfg.range), rng)
        return LidarScan(angles=angles, ranges=ranges, hit=hit,
                         hit_xy=torch.stack([hx, hy], -1))

    support = ((ux.abs() + uy.abs()) * 0.5 * grid.resolution)[..., None]
    uxk, uyk = ux[..., None], uy[..., None]
    best = torch.full(world_ang.shape, math.inf, dtype=_F32, device=grid.device)
    best_px = torch.zeros(world_ang.shape, dtype=torch.int32, device=grid.device)
    best_py = torch.zeros_like(best_px)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            qx = samples.px + ox
            qy = samples.py + oy
            # out of the image reads as free: the reference never updates
            # from out-of-image cells (lidar_model.py:63-65)
            occv = lookup(grid, qx, qy, oob_value=1.0)
            wx, wy = m2w(grid, qx, qy)
            rx = wx - cxb[..., None]
            ry = wy - cyb[..., None]
            along = rx * uxk + ry * uyk
            perp = (ry * uxk - rx * uyk).abs()
            d = _hypot(rx, ry)
            cand = ((occv < 0.5) & (along > 0.0) & (perp <= support)
                    & (d < cfg.range))
            dd = torch.where(cand, d, torch.full_like(d, math.inf))
            k = torch.argmin(dd, -1, keepdim=True)
            dk = torch.take_along_dim(dd, k, -1)[..., 0]
            better = dk < best
            best = torch.where(better, dk, best)
            best_px = torch.where(better,
                                  torch.take_along_dim(qx, k, -1)[..., 0],
                                  best_px)
            best_py = torch.where(better,
                                  torch.take_along_dim(qy, k, -1)[..., 0],
                                  best_py)
    hit = torch.isfinite(best)
    hx, hy = m2w(grid, best_px, best_py)
    hx = torch.where(hit, hx, cxb + cfg.range * ux)
    hy = torch.where(hit, hy, cyb + cfg.range * uy)
    ranges = torch.where(hit, best, torch.full_like(best, cfg.range))
    return LidarScan(angles=angles, ranges=ranges, hit=hit,
                     hit_xy=torch.stack([hx, hy], -1))


# ---------------------------------------------------------------------------
# Static cell tables (host numpy, built once per rollout)
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def occupied_cell_table(occ, pad_multiple: int = 1024) -> torch.Tensor:
    """Pixel coords of every occupied BOUNDARY cell of a static grid (an
    occupied cell with a free 8-neighbour; out of the image counts as
    free), row-major, padded with (-10**6, -10**6) dummies to a multiple of
    ``pad_multiple``.  Returns (M, 2) int32 on ``occ``'s device.

    Boundary-only is exact for a sensor in free space: the chain of cells a
    ray crosses starts at the free sensor cell, so its nearest occupied
    cell has a free 8-adjacent predecessor."""
    occ_np = _host(occ)
    occupied = occ_np < 0.5
    free_p = np.pad(~occupied, 1, constant_values=True)
    near_free = np.zeros_like(occupied)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            near_free |= free_p[dy:dy + occ_np.shape[0],
                                dx:dx + occ_np.shape[1]]
    ys, xs = np.nonzero(occupied & near_free)
    n = xs.shape[0]
    M = max(((n + pad_multiple - 1) // pad_multiple) * pad_multiple,
            pad_multiple)
    out = np.full((M, 2), _DUMMY, np.int32)
    out[:n, 0] = xs
    out[:n, 1] = ys
    dev = occ.device if isinstance(occ, torch.Tensor) else "cpu"
    return torch.tensor(out, device=dev)


def waypoint_cell_table(cells, grid: GridMap, path, radius_m: float,
                        pad_multiple: int = 512) -> torch.Tensor:
    """Per-waypoint pruning of the boundary-cell table: for each waypoint,
    the cells of ``cells`` (:func:`occupied_cell_table`) whose centre lies
    within ``radius_m`` of it, in table order.  Returns (n_wp, K, 2) int32,
    dummy-padded, on the grid's device.

    Exact for scans from poses within ``radius_m - range`` of their
    waypoint: use ``radius_m = range + waypoint_slack(path)``."""
    cells_np = _host(cells)
    real = cells_np[:, 0] > -(10 ** 5)
    px = cells_np[real, 0]
    py = cells_np[real, 1]
    cg = GridMap(occ=grid.occ, origin=grid.origin.cpu(),
                 resolution=grid.resolution.cpu())
    ccx, ccy = (t.numpy() for t in m2w(cg, torch.tensor(px), torch.tensor(py)))
    wx = _host(path.x)
    wy = _host(path.y)
    r2 = float(radius_m) ** 2
    masks = [(ccx - a) ** 2 + (ccy - b) ** 2 < r2 for a, b in zip(wx, wy)]
    kmax = max(int(m.sum()) for m in masks)
    K = max(((kmax + pad_multiple - 1) // pad_multiple) * pad_multiple,
            pad_multiple)
    out = np.full((len(wx), K, 2), _DUMMY, np.int32)
    for n, m in enumerate(masks):
        k = int(m.sum())
        out[n, :k, 0] = px[m]
        out[n, :k, 1] = py[m]
    return torch.tensor(out, device=grid.device)


def waypoint_slack(path) -> float:
    """Safe pose-to-waypoint distance bound for :func:`waypoint_cell_table`:
    (max waypoint-to-border distance) + 2 x (max waypoint spacing)."""
    wx = _host(path.x)[:, None]
    wy = _host(path.y)[:, None]
    b = np.concatenate([_host(path.border_ub), _host(path.border_lb)],
                       axis=1).reshape(wx.shape[0], -1, 2)
    d = np.hypot(b[..., 0] - wx, b[..., 1] - wy).max()
    spacing = _host(path.seg_dist).max()
    return float(d + 2.0 * spacing)


# ---------------------------------------------------------------------------
# Fleet scans
# ---------------------------------------------------------------------------

def scan_fleet(grid: GridMap, x, y, psi, cfg: LidarConfig,
               cells: Optional[torch.Tensor] = None, backend: str = "auto",
               chunk: int = 2048, wp_id: Optional[torch.Tensor] = None,
               max_elems: int = 1 << 27) -> LidarScan:
    """Scans for a fleet of poses (x, y, psi each (B,)).

    Backends: ``march`` (:func:`scan`); ``cells`` (the corner-span test
    swept over ``cells``: a global (M, 2) table, or a per-waypoint (n_wp,
    K, 2) table whose row ``wp_id`` (B,) each lane takes); ``auto`` —
    ``cells`` on a CUDA grid when a table is given, else ``march``.

    ``cells`` sweeps ``chunk`` cells of as many lanes as keep the (lanes,
    cells, beams) intermediates within ``max_elems`` elements at a time.
    Chunking does not change the result: within a chunk a tie goes to the
    smallest packed cell id ``py * W + px``, and across chunks a strict
    ``<`` keeps the earlier chunk's winner, which holds the smaller id
    because table rows are in row-major (id-ascending) order."""
    if backend == "auto":
        backend = ("cells" if cells is not None and grid.device.type == "cuda"
                   else "march")
    if backend == "march":
        return scan(grid, x, y, psi, cfg)
    if backend != "cells":
        raise ValueError(f"unknown scan backend {backend!r}")
    if cells is None:
        raise ValueError("cells backend needs occupied_cell_table(true_occ)")

    dev = grid.device
    B, nb = x.shape[0], cfg.n_beams
    H, W = grid.occ.shape
    # the winning cell is carried as a float32 packed id py * W + px
    assert H * W < (1 << 24), "pid packing needs H*W < 2^24"
    cx, cy = _sensor(grid, x, y)
    rel = beam_angles(cfg, dev)
    ux, uy = _unit(rel[None, :] + psi[:, None])  # (B, nb)
    support = (ux.abs() + uy.abs()) * 0.5 * grid.resolution

    if cells.dim() == 3:  # per-waypoint pruned candidates
        if wp_id is None:
            raise ValueError("per-waypoint cell table needs wp_id")
        cells_b = cells[wp_id.long()]  # (B, K, 2)
    else:
        cells_b = cells[None]  # (1, M, 2), every lane
    M = cells_b.shape[1]
    C = min(chunk, M)
    Bc = max(1, min(B, max_elems // (C * nb)))

    acc_d = torch.full((B, nb), _BIG, dtype=_F32, device=dev)
    acc_pid = torch.full((B, nb), _BIG, dtype=_F32, device=dev)
    for b0 in range(0, B, Bc):
        b1 = min(b0 + Bc, B)
        lanes = slice(b0, b1) if cells_b.shape[0] > 1 else slice(0, 1)
        cxl, cyl = cx[b0:b1, None], cy[b0:b1, None]
        uxl, uyl = ux[b0:b1, None, :], uy[b0:b1, None, :]
        supl = support[b0:b1, None, :]
        for c0 in range(0, M, C):
            gpx = cells_b[lanes, c0:c0 + C, 0]
            gpy = cells_b[lanes, c0:c0 + C, 1]
            gx, gy = m2w(grid, gpx, gpy)
            pid = (gpy * W + gpx).to(_F32)[:, :, None]
            dx = gx - cxl  # (lanes, C)
            dy = gy - cyl
            d = torch.sqrt(dx * dx + dy * dy)
            in_range = ((d < cfg.range) & (d > 0.0))[:, :, None]
            dx, dy = dx[:, :, None], dy[:, :, None]
            # (lanes, C, nb) pair tests: the corner-span reduction
            along = dx * uxl
            along += dy * uyl
            hit = along > 0.0
            del along
            perp = dy * uxl
            perp -= dx * uyl
            hit &= perp.abs_() <= supl
            del perp
            hit &= in_range
            dt = torch.where(hit, d[:, :, None], _BIG)
            del hit
            c_d = dt.amin(1)  # (lanes, nb)
            is_min = (dt <= c_d[:, None, :]) & (c_d < _BIG)[:, None, :]
            del dt
            c_pid = torch.where(is_min, pid, _BIG).amin(1)
            del is_min
            better = c_d < acc_d[b0:b1]
            acc_d[b0:b1] = torch.where(better, c_d, acc_d[b0:b1])
            acc_pid[b0:b1] = torch.where(better, c_pid, acc_pid[b0:b1])

    hit = acc_d < cfg.range
    pid_i = torch.where(hit, acc_pid, 0.0).to(torch.int32)
    hx, hy = m2w(grid, pid_i % W, pid_i // W)
    hx = torch.where(hit, hx, cx[:, None] + cfg.range * ux)
    hy = torch.where(hit, hy, cy[:, None] + cfg.range * uy)
    ranges = torch.where(hit, acc_d, cfg.range)
    return LidarScan(angles=rel.expand(B, nb), ranges=ranges, hit=hit,
                     hit_xy=torch.stack([hx, hy], -1))


def measurements(scan_out: LidarScan) -> torch.Tensor:
    """(..., 2, n_beams) stacked (angle, range): the reference's
    ``self.measurements`` layout (lidar_model.py:31-35)."""
    return torch.stack([scan_out.angles, scan_out.ranges], dim=-2)


# ---------------------------------------------------------------------------
# Map write-back
# ---------------------------------------------------------------------------

def hit_pixels(grid: GridMap, scans: LidarScan, h: int, w: int):
    """Pixel coords of the scans' hit cells, clipped into an (h, w) grid."""
    hpx, hpy = w2m(grid, scans.hit_xy[..., 0], scans.hit_xy[..., 1])
    return hpx.clamp(0, w - 1), hpy.clamp(0, h - 1)


def free_space_pixels(grid: GridMap, x, y, psi, scan_out: LidarScan,
                      free_samples: int = 64):
    """Pixel coords of the cells along each beam up to 95 % of its measured
    range — the cells a scan observed as free — clipped into the grid.
    Poses (B,) with scans (B, nb) give (B, nb * F); one pose gives
    (nb * F,)."""
    h, w = grid.occ.shape
    cx, cy = _sensor(grid, x, y)
    ux, uy = _unit(scan_out.angles + psi[..., None])
    t = linspace_f32(0.0, 0.95, free_samples, grid.device)
    reach = scan_out.ranges[..., None] * t  # (..., nb, F)
    rx = cx[..., None, None] + reach * ux[..., None]
    ry = cy[..., None, None] + reach * uy[..., None]
    fpx, fpy = w2m(grid, rx, ry)
    flat = lambda a: a.reshape(*a.shape[:-2], -1)
    return flat(fpx.clamp(0, w - 1)), flat(fpy.clamp(0, h - 1))


def scatter_writeback_(grid: GridMap, occ: torch.Tensor, x, y, psi,
                       scans: LidarScan, clear_free: bool = False,
                       shared: bool = False,
                       free_samples: int = 64) -> torch.Tensor:
    """Write a fleet's scans into ``occ`` IN PLACE and return it: per-lane
    (B, H, W), or one shared (H, W) grid pooling every lane (``shared``).
    Observed-free cells take ``max(occ, 1)``, then hit cells ``min(occ,
    0)`` (a missed beam's end cell ``min(occ, 1)``): the JAX package's
    ``.at[].max`` / ``.at[].min`` scatters, order-independent per class.
    ``occ`` must be contiguous and owned by the caller: an ``expand``-ed
    stack would alias every lane's map."""
    if not occ.is_contiguous():
        raise ValueError("scatter write-back needs a contiguous grid")
    h, w = occ.shape[-2:]
    B = scans.hit.shape[0]
    flat = occ.view(-1)
    lane = (0 if shared else
            torch.arange(B, device=occ.device)[:, None] * (h * w))

    def cells(px, py):
        return (lane + py.long() * w + px.long()).reshape(-1)

    if clear_free:
        fpx, fpy = free_space_pixels(grid, x, y, psi, scans, free_samples)
        flat.scatter_reduce_(0, cells(fpx, fpy),
                             torch.ones(fpx.numel(), dtype=occ.dtype,
                                        device=occ.device), reduce="amax")
    hpx, hpy = hit_pixels(grid, scans, h, w)
    val = torch.where(scans.hit, 0.0, 1.0).to(occ.dtype).reshape(-1)
    flat.scatter_reduce_(0, cells(hpx, hpy), val, reduce="amin")
    return occ


def update_grid_from_scan(grid: GridMap, x, y, psi, scan_out: LidarScan,
                          cfg: LidarConfig, clear_free: bool = False,
                          free_samples: int = 64) -> GridMap:
    """Write one scan's hits (and, with ``clear_free``, its observed-free
    cells) into a new grid: the online map update (BASELINE.json config 4;
    the reference's ROS node did it, README.md:76)."""
    x, y, psi = (torch.as_tensor(v, dtype=_F32, device=grid.device).reshape(1)
                 for v in (x, y, psi))
    one = LidarScan(*(f[None] for f in scan_out))
    occ = scatter_writeback_(grid, grid.occ.clone()[None], x, y, psi, one,
                             clear_free=clear_free,
                             free_samples=free_samples)[0]
    return GridMap(occ=occ, origin=grid.origin, resolution=grid.resolution)


def _point_mask(py, px, valid, h: int, w: int, shared: bool) -> torch.Tensor:
    """Dense bool mask of the points (py, px) (B, S), per lane (B, h, w) or
    pooled (h, w); points with ``valid`` False go to a spare slot past the
    end, so no mask entry is ever reset and no host sync is needed."""
    B = py.shape[0]
    n = h * w if shared else B * h * w
    idx = py.long() * w + px.long()
    if not shared:
        idx = idx + torch.arange(B, device=py.device)[:, None] * (h * w)
    if valid is not None:
        idx = torch.where(valid, idx, n)
    mask = torch.zeros(n + 1, dtype=torch.bool, device=py.device)
    # the value as a device tensor: ``mask[idx] = True`` copies a host
    # scalar to the card, a sync a step captured in a CUDA graph must not do
    mask.index_put_((idx.reshape(-1),),
                    torch.ones((), dtype=torch.bool, device=py.device))
    return mask[:n].view((h, w) if shared else (B, h, w))


def fleet_observation_masks(grid: GridMap, h: int, w: int, x, y, psi,
                            scans: LidarScan, cfg: LidarConfig,
                            clear_free: bool = False, shared: bool = False,
                            free_samples: int = 64):
    """``(hitmask, freemask)`` of a fleet's scans: bool (B, h, w) per lane,
    or (h, w) pooled over the lanes (``shared``); ``freemask`` is None
    unless ``clear_free``.  Kept apart from :func:`fleet_writeback` so that
    masks can be pooled (logical or) before the single grid update."""
    hpx, hpy = hit_pixels(grid, scans, h, w)
    freemask = None
    if clear_free:
        fpx, fpy = free_space_pixels(grid, x, y, psi, scans, free_samples)
        freemask = _point_mask(fpy, fpx, None, h, w, shared)
    return _point_mask(hpy, hpx, scans.hit, h, w, shared), freemask


def apply_observation_masks(occ: torch.Tensor, hitmask: torch.Tensor,
                            freemask: Optional[torch.Tensor]) -> torch.Tensor:
    """Elementwise grid update from observation masks: free-space clearing
    first, hits after, so an observed obstacle always wins."""
    if freemask is not None:
        occ = torch.where(freemask, torch.ones_like(occ), occ)
    return torch.where(hitmask, torch.zeros_like(occ), occ)


def pool_observation_masks(hitmask: torch.Tensor,
                           freemask: Optional[torch.Tensor], group):
    """Pool a shared map's observation masks over the ranks of ``group``
    (a ``torch.distributed`` process group): the logical or of every rank's
    masks, one MAX all-reduce per mask class, on uint8 (NCCL and gloo both
    reduce it; the JAX package's ``pmax`` takes float32).  The or is
    order-free, so every rank gets the same masks as one device pooling
    all lanes."""

    def pooled(mask):
        m = mask.to(torch.uint8)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        return m.bool()

    return pooled(hitmask), None if freemask is None else pooled(freemask)


def fleet_writeback(grid: GridMap, occ: torch.Tensor, x, y, psi,
                    scans: LidarScan, cfg: LidarConfig,
                    clear_free: bool = False, shared: bool = False,
                    free_samples: int = 64) -> torch.Tensor:
    """Batched online map update through dense masks, returning a new grid:
    ``occ`` (B, H, W) per lane, or (H, W) pooling every lane (``shared``).
    The same result as :func:`scatter_writeback_`."""
    h, w = occ.shape[-2:]
    hitmask, freemask = fleet_observation_masks(
        grid, h, w, x, y, psi, scans, cfg, clear_free=clear_free,
        shared=shared, free_samples=free_samples)
    return apply_observation_masks(occ, hitmask, freemask)
