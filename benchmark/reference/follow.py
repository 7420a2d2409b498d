"""The reference's corridor, violation floor, LiDAR scan and map
write-back for a batch of lanes (the QP solve is :mod:`.admm`): free runs
on the scanlines of the horizon waypoints and the continuity selection,
interval reachability, the corner-span scan.

Semantics of the upstream controller as the configuration states it
(MPC.py, reference_path.py, lidar_model.py): the corridor covers the
waypoints wp+1 .. wp+N, the dynamics wp .. wp+N-1; a scanline has K
samples from the static left border to the right one (out of the image
reads occupied); a free run's borders are the cells just outside it, and
runs no wider than twice the safety margin are dropped, at most S kept in
order; stage 0 takes the widest run, each later one the run nearest to
the previous borders projected along the path; the bounds are the
signed distances of the borders less the margin, 0 and 0 where they
cross.  A beam reports the nearest occupied boundary cell whose square
it crosses (ties to the smaller row-major id), and a hit cell is written
occupied."""

from __future__ import annotations

import math

import torch

from benchmark.reference import world as W

F64 = torch.float64
F32 = torch.float32


def scanlines(w: W.World, K: int):
    """Per waypoint the K scanline pixels and their float64 cell centres:
    (px, py, cx, cy), (n_wp, K) each."""
    px, py = W.line_samples(w.border_ub, w.border_lb, K, w.origin, w.res)
    cx, cy = W.centre(w.origin, w.res, px, py)
    return px, py, cx, cy


def read_maps(maps: torch.Tensor, px, py):
    """maps (L, H, W), or one map (H, W) for every lane, read at (L, ...)
    pixels; out of the image: 0."""
    if maps.dim() == 2:
        return W.read_occ(maps, px, py)
    L, H, Wd = maps.shape
    inb = (px >= 0) & (px < Wd) & (py >= 0) & (py < H)
    flat = (py.clamp(0, H - 1) * Wd + px.clamp(0, Wd - 1)).reshape(L, -1)
    v = maps.reshape(L, -1).gather(1, flat).reshape(px.shape)
    return torch.where(inb, v, torch.zeros_like(v))


def free_runs(free: torch.Tensor, cx, cy, min_width: float, S: int):
    """(ub_xy, lb_xy, valid) of the first S free runs wider than
    ``min_width`` along the last axis of ``free`` (..., K)."""
    K = free.shape[-1]
    no = torch.zeros_like(free[..., :1])
    starts = free & ~torch.cat([no, free[..., :-1]], -1)
    ends = free & ~torch.cat([free[..., 1:], no], -1)
    R = K // 2 + 1
    k = torch.arange(K, device=free.device).expand_as(free)
    # the r-th start / end: the position whose running count first reaches r
    rs = torch.cumsum(starts.long(), -1)
    re = torch.cumsum(ends.long(), -1)
    r = torch.arange(1, R + 1, device=free.device)
    first = lambda cnt, mark: torch.where(
        (cnt[..., None, :] == r[:, None]) & mark[..., None, :],
        k[..., None, :], torch.full_like(k[..., None, :], K)).amin(-1)
    a, b = first(rs, starts), first(re, ends)  # (..., R)
    exists = a < K
    ui = (a - 1).clamp(0, K - 1)
    li = (b + 1).clamp(0, K - 1)
    g = lambda v, i: v.gather(-1, i)
    ubx, uby, lbx, lby = g(cx, ui), g(cy, ui), g(cx, li), g(cy, li)
    valid = exists & (torch.hypot(ubx - lbx, uby - lby) > min_width)
    order = torch.cumsum(valid.long(), -1) - 1
    slot = torch.where(valid & (order < S), order, torch.full_like(order, S))
    out = lambda v: torch.zeros(v.shape[:-1] + (S + 1,), dtype=v.dtype,
                                device=v.device).scatter(-1, slot, v)[..., :S]
    keep = torch.zeros(valid.shape[:-1] + (S + 1,), dtype=torch.bool,
                       device=free.device).scatter(-1, slot, valid)[..., :S]
    return (torch.stack([out(ubx), out(uby)], -1),
            torch.stack([out(lbx), out(lby)], -1), keep)


def select(w: W.World, idx, ub_xy, lb_xy, valid, sm: float):
    """(ub, lb) (L, N) of the corridor at the horizon waypoints ``idx``."""
    L, N = idx.shape
    wx, wy, wpsi = w.x[idx], w.y[idx], w.psi[idx]
    prev = torch.cat([idx[:, :1], idx[:, :-1]], 1)
    ds, ppsi = w.seg_dist[prev], w.psi[prev]
    rows = torch.arange(L, device=idx.device)
    ub_prev = lb_prev = None
    ubs, lbs = [], []
    for n in range(N):
        u, l, v = ub_xy[:, n], lb_xy[:, n], valid[:, n]
        if n == 0:
            width = torch.hypot(u[..., 0] - l[..., 0], u[..., 1] - l[..., 1])
            sel = torch.argmax(torch.where(v, width, -math.inf), -1)
        else:
            proj = ds[:, n, None] * torch.stack([torch.cos(ppsi[:, n]),
                                                 torch.sin(ppsi[:, n])], -1)
            pu, pl = (ub_prev + proj)[:, None], (lb_prev + proj)[:, None]
            off = (torch.hypot(u[..., 0] - pu[..., 0], u[..., 1] - pu[..., 1])
                   + torch.hypot(l[..., 0] - pl[..., 0],
                                 l[..., 1] - pl[..., 1])) / 2
            sel = torch.argmin(torch.where(v, off, math.inf), -1)
        xy = torch.stack([wx[:, n], wy[:, n]], -1)
        anyv = v.any(-1, keepdim=True)
        su = torch.where(anyv, u[rows, sel], xy)
        sl = torch.where(anyv, l[rows, sel], xy)
        a_u = W.wrap(torch.atan2(su[:, 1] - xy[:, 1], su[:, 0] - xy[:, 0])
                     - wpsi[:, n])
        a_l = W.wrap(torch.atan2(sl[:, 1] - xy[:, 1], sl[:, 0] - xy[:, 0])
                     - wpsi[:, n])
        ub = torch.sign(a_u) * torch.hypot(su[:, 0] - xy[:, 0],
                                           su[:, 1] - xy[:, 1]) - sm
        lb = torch.sign(a_l) * torch.hypot(sl[:, 0] - xy[:, 0],
                                           sl[:, 1] - xy[:, 1]) + sm
        cross = ub < lb
        ub = torch.where(cross, torch.zeros_like(ub), ub)
        lb = torch.where(cross, torch.zeros_like(lb), lb)
        du = torch.stack([torch.cos(W.wrap(wpsi[:, n] + math.pi / 2)),
                          torch.sin(W.wrap(wpsi[:, n] + math.pi / 2))], -1)
        dl = torch.stack([torch.cos(W.wrap(wpsi[:, n] - math.pi / 2)),
                          torch.sin(W.wrap(wpsi[:, n] - math.pi / 2))], -1)
        ub_prev = xy + (ub + sm)[:, None] * du
        lb_prev = xy - (lb - sm)[:, None] * dl
        ubs.append(ub)
        lbs.append(lb)
    return torch.stack(ubs, 1), torch.stack(lbs, 1)


def floor(e_y, e_psi, kappa, ds, lb, ub, kmax: float):
    """Certified lower bound on the corridor violation of every
    dynamics-consistent horizon trajectory (interval reachability), 0
    where the corridor collapsed somewhere."""
    y_lo = y_hi = e_y
    p_lo = p_hi = e_psi
    out = torch.zeros_like(e_y)
    for n in range(kappa.shape[1]):
        k, d = kappa[:, n], ds[:, n]
        ny_lo, ny_hi = y_lo + d * p_lo, y_hi + d * p_hi
        c = -(k * k) * d
        t_lo = torch.minimum(c * y_lo, c * y_hi)
        t_hi = torch.maximum(c * y_lo, c * y_hi)
        p_lo, p_hi = t_lo + p_lo + d * (-kmax - k), t_hi + p_hi + d * (kmax - k)
        out = torch.maximum(out, torch.clamp(
            torch.maximum(lb[:, n] - ny_hi, ny_lo - ub[:, n]), min=0.0))
        y_lo, y_hi = ny_lo, ny_hi
    return torch.where(((ub - lb) > 0).all(1), out, torch.zeros_like(out))


def boundary_cells(occ: torch.Tensor) -> torch.Tensor:
    """(M, 2) pixels of the occupied cells with a free 8-neighbour (out of
    the image counts as free), in row-major order."""
    occupied = occ < 0.5
    free = torch.nn.functional.pad(~occupied, (1, 1, 1, 1), value=True)
    H, Wd = occupied.shape
    near = torch.zeros_like(occupied)
    for dy in range(3):
        for dx in range(3):
            if dy != 1 or dx != 1:
                near |= free[dy:dy + H, dx:dx + Wd]
    ys, xs = torch.nonzero(occupied & near, as_tuple=True)
    return torch.stack([xs, ys], -1)


def beams(lidar: dict, psi: torch.Tensor):
    """(ux, uy) (L, nb) float32 beam directions: float32 angles from -FoV/2
    to FoV/2 plus the yaw, cos and sin rounded once from float64."""
    nb = int(lidar["FoV"] / lidar["resolution"] + 1)
    half = math.pi / 360.0 * lidar["FoV"]
    t = W.unit_t(nb, psi.device)
    lo = torch.full((), -half, dtype=F32, device=psi.device)
    hi = torch.full((), half, dtype=F32, device=psi.device)
    ang = ((lo * (1 - t) + hi * t)[None] + psi.to(F32)[:, None]).to(F64)
    return torch.cos(ang).to(F32), torch.sin(ang).to(F32)


def scan(w: W.World, cells, lidar: dict, x, y, psi, chunk: int = 64):
    """The hit of every beam of L poses: ``(pid, d)`` (L, nb), the hit
    cell's packed id py * W + px (-1 on a miss) and its distance (the
    range on a miss).  Which cell a beam hits is a choice among cells,
    made in the configuration's float32: the sensor at the centre of the
    pose's cell, a cell's square crossed where the beam points at it and
    passes within its half-width (|ux| + |uy|) res / 2, the nearest centre
    within (0, range) first, ties to the smaller id."""
    Wd = w.occ.shape[1]
    rng = lidar["range"]
    res = torch.tensor(w.res, dtype=F32, device=x.device)
    gx, gy = W.centre32(w.origin, w.res, cells[:, 0], cells[:, 1])
    pid = cells[:, 1] * Wd + cells[:, 0]
    big = torch.iinfo(torch.long).max
    pids, ds = [], []
    for i in range(0, x.shape[0], chunk):
        sl = slice(i, i + chunk)
        spx, spy = W.pixel(w.origin, w.res, x[sl].to(F32), y[sl].to(F32))
        cx, cy = W.centre32(w.origin, w.res, spx, spy)
        ux, uy = beams(lidar, psi[sl])
        sup = (ux.abs() + uy.abs()) * 0.5 * res
        dx, dy = gx[None] - cx[:, None], gy[None] - cy[:, None]  # (l, M)
        d = torch.sqrt(dx * dx + dy * dy)
        near = (d < rng) & (d > 0)
        # the cells in range first, in table order: (l, k) with k the most
        # any lane of the chunk has
        k = max(int(near.sum(1).max()), 1)
        idx = torch.sort((~near).to(torch.int8), dim=1, stable=True)[1][:, :k]
        take = lambda t: t.gather(1, idx)
        dx, dy, d, near, cpid = take(dx), take(dy), take(d), take(near), \
            pid[idx]
        along = dx[..., None] * ux[:, None] + dy[..., None] * uy[:, None]
        perp = dy[..., None] * ux[:, None] - dx[..., None] * uy[:, None]
        ok = (along > 0) & (perp.abs() <= sup[:, None]) & near[..., None]
        key = torch.where(ok, d[..., None], math.inf)
        best = key.amin(1)
        win = torch.where(ok & (key == best[:, None]), cpid[..., None],
                          big).amin(1)
        hit = torch.isfinite(best)
        pids.append(torch.where(hit, win, torch.full_like(win, -1)))
        ds.append(torch.where(hit, best, torch.full_like(best, rng)))
    return torch.cat(pids), torch.cat(ds)


def scan_hits(w: W.World, cells, lidar: dict, x, y, psi):
    """The hit cells (L, nb) of :func:`scan`, -1 on a miss."""
    return scan(w, cells, lidar, x, y, psi)[0]


def write_hits(maps: torch.Tensor, hits: torch.Tensor):
    """Hit cells of (L, nb) packed ids written occupied into maps (L, H, W)."""
    L, H, Wd = maps.shape
    lane = torch.arange(L, device=maps.device)[:, None] * (H * Wd)
    flat = (lane + hits.clamp(min=0)).reshape(-1)
    val = torch.where(hits >= 0, 0.0, 1.0).to(maps.dtype).reshape(-1)
    maps.view(-1).scatter_reduce_(0, flat, val, reduce="amin")
    return maps
