"""Dynamic drivable-corridor constraints (port of ``ops/constraints.py``).

1. Free-segment extraction: sample K points along the scanline between the
   static border cells, find maximal free runs, keep up to
   ``max_segments`` candidates as world endpoints + valid mask
   (reference_path.py:466-520).
2. Continuity selection over the horizon: step 0 takes the widest segment;
   step n projects the previously selected borders forward and takes the
   candidate with the smallest mean endpoint offset; no candidate collapses
   the corridor to ub = lb = 0 (reference_path.py:535-648, with the
   intended forward projection for both borders).

:func:`select_corridor` keeps the JAX package's atan2 formulation; the
main path's selection is kernel K2 (:mod:`.corridor_cuda`), whose twin uses
the kernel's cross-product formulation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from multi_purpose_mpc_tpu_torch.ops.grid import GridMap, m2w
from multi_purpose_mpc_tpu_torch.ops.path import PathData, gather_waypoint_index, wrap_angle
from multi_purpose_mpc_tpu_torch.ops.rays import sample_line


class SegmentCandidates(NamedTuple):
    ub_xy: torch.Tensor  # (..., S, 2) world coords of upper (left) endpoints
    lb_xy: torch.Tensor  # (..., S, 2) world coords of lower (right) endpoints
    valid: torch.Tensor  # (..., S) bool

    def index(self, idx) -> "SegmentCandidates":
        return SegmentCandidates(self.ub_xy[idx], self.lb_xy[idx],
                                 self.valid[idx])


class Corridor(NamedTuple):
    ub: torch.Tensor  # (B, N) upper e_y bound (safety margin applied)
    lb: torch.Tensor  # (B, N) lower e_y bound
    border_ub: torch.Tensor  # (B, N, 2) world border points
    border_lb: torch.Tensor  # (B, N, 2)


def segments_from_samples(occ, cx, cy, min_width,
                          max_segments: int) -> SegmentCandidates:
    """Free segments from sampled scanline occupancy ``occ`` (..., K) with
    sample cell centers ``cx``/``cy`` (..., K).  Endpoints are the occupied
    (or border) cells delimiting each free run; runs narrower than
    ``min_width`` are dropped and the rest compacted to the front."""
    free = occ > 0.5
    K = occ.shape[-1]
    dev = occ.device
    lead = free.shape[:-1]
    no = torch.zeros(lead + (1,), dtype=torch.bool, device=dev)
    prev_free = torch.cat([no, free[..., :-1]], -1)
    next_free = torch.cat([free[..., 1:], no], -1)
    starts = free & ~prev_free
    ends = free & ~next_free

    # every run first (at most K//2 + 1), then width-filter and compact
    raw = K // 2 + 1
    rs = torch.cumsum(starts.to(torch.int32), -1)
    re_ = torch.cumsum(ends.to(torch.int32), -1)
    r_iota = torch.arange(1, raw + 1, dtype=torch.int32, device=dev)[:, None]
    k_iota = torch.arange(K, dtype=torch.int32, device=dev)
    sOH = starts[..., None, :] & (rs[..., None, :] == r_iota)  # (..., raw, K)
    eOH = ends[..., None, :] & (re_[..., None, :] == r_iota)
    start_idx = (sOH * k_iota).sum(-1)
    end_idx = (eOH * k_iota).sum(-1)
    valid = r_iota[:, 0] <= rs[..., -1:]

    ub_i = torch.clamp(start_idx - 1, min=0).long()
    lb_i = torch.clamp(end_idx + 1, max=K - 1).long()
    ubx, uby = torch.gather(cx, -1, ub_i), torch.gather(cy, -1, ub_i)
    lbx, lby = torch.gather(cx, -1, lb_i), torch.gather(cy, -1, lb_i)
    valid = valid & (torch.hypot(ubx - lbx, uby - lby) > min_width)

    pos = torch.cumsum(valid.to(torch.int32), -1) - 1
    s_iota = torch.arange(max_segments, dtype=torch.int32, device=dev)[:, None]
    cOH = valid[..., None, :] & (pos[..., None, :] == s_iota)  # (..., S, raw)
    cf = cOH.to(occ.dtype)
    pick = lambda v: (cf * v[..., None, :]).sum(-1)
    return SegmentCandidates(
        ub_xy=torch.stack([pick(ubx), pick(uby)], -1),
        lb_xy=torch.stack([pick(lbx), pick(lby)], -1),
        valid=cOH.any(-1))


def free_segments(grid: GridMap, p_ub, p_lb, min_width,
                  n_samples: int, max_segments: int) -> SegmentCandidates:
    """Free segments along the scanlines from ``p_ub`` to ``p_lb`` (..., 2)."""
    s = sample_line(grid, p_ub[..., 0], p_ub[..., 1], p_lb[..., 0],
                    p_lb[..., 1], n_samples)
    cx, cy = m2w(grid, s.px, s.py)
    return segments_from_samples(s.occ, cx, cy, min_width, max_segments)


def extract_all_segments(grid: GridMap, path: PathData, min_width,
                         n_samples: int = 128,
                         max_segments: int = 8) -> SegmentCandidates:
    """Free segments for every waypoint — the static-grid precomputation
    (leading axis n_wp), run once per rollout."""
    return free_segments(grid, path.border_ub, path.border_lb, min_width,
                         n_samples, max_segments)


def select_corridor(path: PathData, idx, segs: SegmentCandidates,
                    safety_margin) -> Corridor:
    """Continuity-based segment selection over the horizon for a fleet:
    ``idx`` (B, N) horizon waypoint indices, ``segs`` (B, N, S, ...)."""
    idx = idx.long()
    N = idx.shape[1]
    sm = safety_margin
    wx, wy, wpsi = path.x[idx], path.y[idx], path.psi[idx]
    prev_idx = torch.cat([idx[:, :1], idx[:, :-1]], 1)
    delta_s = path.seg_dist[prev_idx]
    prev_psi = path.psi[prev_idx]

    ub_prev = torch.zeros((idx.shape[0], 2), dtype=wx.dtype, device=wx.device)
    lb_prev = torch.zeros_like(ub_prev)
    ubs, lbs, cubs, clbs = [], [], [], []
    for n in range(N):
        ub_xy, lb_xy, valid = segs.ub_xy[:, n], segs.lb_xy[:, n], segs.valid[:, n]
        x, y, psi = wx[:, n], wy[:, n], wpsi[:, n]
        if n == 0:  # widest segment
            width = torch.hypot(ub_xy[..., 0] - lb_xy[..., 0],
                                ub_xy[..., 1] - lb_xy[..., 1])
            sel = torch.argmax(torch.where(valid, width, -math.inf), -1)
        else:  # closest to the forward-projected previous borders
            proj = delta_s[:, n, None] * torch.stack(
                [torch.cos(prev_psi[:, n]), torch.sin(prev_psi[:, n])], -1)
            ub_pw = (ub_prev + proj)[:, None]
            lb_pw = (lb_prev + proj)[:, None]
            d_ub = torch.hypot(ub_xy[..., 0] - ub_pw[..., 0],
                               ub_xy[..., 1] - ub_pw[..., 1])
            d_lb = torch.hypot(lb_xy[..., 0] - lb_pw[..., 0],
                               lb_xy[..., 1] - lb_pw[..., 1])
            offset = (d_ub + d_lb) / 2.0
            sel = torch.argmin(torch.where(valid, offset, math.inf), -1)

        xy = torch.stack([x, y], -1)
        any_valid = valid.any(-1, keepdim=True)
        rows = torch.arange(sel.shape[0], device=sel.device)
        ub_ls = torch.where(any_valid, ub_xy[rows, sel], xy)
        lb_ls = torch.where(any_valid, lb_xy[rows, sel], xy)

        # signed distances orthogonal to the path
        ang_ub = wrap_angle(torch.atan2(ub_ls[:, 1] - y, ub_ls[:, 0] - x) - psi)
        ang_lb = wrap_angle(torch.atan2(lb_ls[:, 1] - y, lb_ls[:, 0] - x) - psi)
        ub = torch.sign(ang_ub) * torch.hypot(ub_ls[:, 0] - x, ub_ls[:, 1] - y)
        lb = torch.sign(ang_lb) * torch.hypot(lb_ls[:, 0] - x, lb_ls[:, 1] - y)
        ub = ub - sm
        lb = lb + sm
        infeasible = ub < lb
        ub = torch.where(infeasible, torch.zeros_like(ub), ub)
        lb = torch.where(infeasible, torch.zeros_like(lb), lb)

        # border cells on the orthogonal line: margin-reduced for the QP and
        # display, margin re-added for the next step's projection
        a_ub = wrap_angle(psi + math.pi / 2.0)
        a_lb = wrap_angle(psi - math.pi / 2.0)
        dir_ub = torch.stack([torch.cos(a_ub), torch.sin(a_ub)], -1)
        dir_lb = torch.stack([torch.cos(a_lb), torch.sin(a_lb)], -1)
        cubs.append(xy + ub[:, None] * dir_ub)
        clbs.append(xy - lb[:, None] * dir_lb)
        ub_prev = xy + (ub + sm)[:, None] * dir_ub
        lb_prev = xy - (lb - sm)[:, None] * dir_lb
        ubs.append(ub)
        lbs.append(lb)
    return Corridor(ub=torch.stack(ubs, 1), lb=torch.stack(lbs, 1),
                    border_ub=torch.stack(cubs, 1),
                    border_lb=torch.stack(clbs, 1))


def corridor_from_segments(path: PathData, all_segs: SegmentCandidates,
                           wp_id, N: int, safety_margin) -> Corridor:
    """Corridor from precomputed per-waypoint candidates: gather the N
    horizon rows per lane (``wp_id`` (B,) horizon start), then select."""
    offs = torch.arange(N, device=wp_id.device)
    idx = gather_waypoint_index(path, wp_id.long()[:, None], offs[None, :])
    return select_corridor(path, idx, all_segs.index(idx), safety_margin)
