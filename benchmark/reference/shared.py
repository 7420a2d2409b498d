"""The reference's one map that a whole fleet builds together (a shared
map, pooled over every lane of every rank), rebuilt from the lanes'
logged poses with the reference's own scans.

Semantics of the configuration's online map update with free-space
clearing (lidar_model.py, the ROS node's map refresh): each beam observes
free the cells under ``FREE_SAMPLES`` float32 points spaced evenly from
the sensor (the centre of the pose's cell) to ``FREE_REACH`` of its
measured range, clipped into the image, and its hit cell occupied; the
observations of every lane are pooled (the or of every lane's) and
written into the one map, the free cells first and the hits after, so an
observed obstacle always wins.  The map is all free at the start of a
call and is updated once a step, before any lane reads it."""

from __future__ import annotations

import torch

from benchmark.reference import follow as F
from benchmark.reference import world as W

F64 = torch.float64
F32 = torch.float32
FREE_SAMPLES = 64
FREE_REACH = 0.95


def free_pixels(w: W.World, lidar: dict, x, y, psi, ranges,
                samples: int = FREE_SAMPLES):
    """(px, py) (L, nb * samples) int64 pixels of the cells each beam of L
    poses observed free, for the beams' measured ``ranges`` (L, nb)."""
    H, Wd = w.occ.shape
    L = x.shape[0]
    spx, spy = W.pixel(w.origin, w.res, x.to(F32), y.to(F32))
    cx, cy = W.centre32(w.origin, w.res, spx, spy)
    ux, uy = F.beams(lidar, psi)
    t = torch.tensor(FREE_REACH, dtype=F32, device=x.device) \
        * W.unit_t(samples, x.device)
    reach = ranges.to(F32)[..., None] * t  # (L, nb, samples)
    rx = cx[:, None, None] + reach * ux[..., None]
    ry = cy[:, None, None] + reach * uy[..., None]
    px, py = W.pixel(w.origin, w.res, rx, ry)
    return (px.clamp(0, Wd - 1).reshape(L, -1),
            py.clamp(0, H - 1).reshape(L, -1))


def pooled_masks(w: W.World, cells, lidar: dict, x, y, psi,
                 chunk: int = 256):
    """``(hit, free)`` (H, W) bool: the cells that any of the L poses' scans
    hit, and those that any of their beams observed free."""
    H, Wd = w.occ.shape
    hit = torch.zeros(H * Wd, dtype=torch.bool, device=x.device)
    free = torch.zeros_like(hit)
    for i in range(0, x.shape[0], chunk):
        sl = slice(i, i + chunk)
        pid, d = F.scan(w, cells, lidar, x[sl], y[sl], psi[sl], chunk)
        hit[pid[pid >= 0]] = True
        fpx, fpy = free_pixels(w, lidar, x[sl], y[sl], psi[sl], d)
        free[(fpy * Wd + fpx).reshape(-1)] = True
    return hit.view(H, Wd), free.view(H, Wd)


def update(occ: torch.Tensor, hit: torch.Tensor, free: torch.Tensor):
    """The map after one step's pooled observations: free first, hits
    after."""
    occ = torch.where(free, torch.ones_like(occ), occ)
    return torch.where(hit, torch.zeros_like(occ), occ)


def shared_maps(w: W.World, lidar: dict, x, y, psi, chunk: int = 256):
    """(T, H, W) float64: the shared map after each step's update, from an
    all-free map and the (T, B) pre-step poses of every lane."""
    cells = F.boundary_cells(w.occ)
    occ = torch.ones(tuple(w.occ.shape), dtype=F64, device=x.device)
    maps = []
    for t in range(x.shape[0]):
        occ = update(occ, *pooled_masks(w, cells, lidar, x[t], y[t], psi[t],
                                        chunk))
        maps.append(occ)
    return torch.stack(maps)
