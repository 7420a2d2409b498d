"""Windowed horizon table (port of ``ops/horizon_table.py``).

Horizon indices are consecutive waypoints, so every per-(waypoint,
horizon-step) quantity a control step consumes is pre-windowed once at
setup into an ``(n_wp, N, F)`` table; each step then takes one contiguous
``table[wp_id]`` block of (B, N, F) and slices columns.

Per base waypoint ``w`` and horizon step ``n`` the row packs:

* corridor-selection inputs at waypoint ``w + 1 + n``: x, y, cos psi,
  sin psi, the previous step's ds / cos psi / sin psi, and the static
  free-segment candidates (ub_xy, lb_xy interleaved per segment, valid);
* QP inputs at waypoint ``w + n``: v_ref, kappa, delta_s.
"""

from __future__ import annotations

import torch

from multi_purpose_mpc_tpu_torch.config import MPCConfig
from multi_purpose_mpc_tpu_torch.ops.constraints import Corridor, SegmentCandidates
from multi_purpose_mpc_tpu_torch.ops.corridor_cuda import NPOSE, corridor_select
from multi_purpose_mpc_tpu_torch.ops.path import PathData, gather_waypoint_index


def _cols(S: int):
    ub0 = NPOSE
    lb0 = ub0 + 2 * S
    va0 = lb0 + 2 * S
    sol0 = va0 + S
    return ub0, lb0, va0, sol0, sol0 + 3  # ..., total F


def build_horizon_table(path: PathData, segs: SegmentCandidates,
                        cfg: MPCConfig) -> torch.Tensor:
    """(n_wp, N, F) float32 window table; see the module docstring."""
    N = cfg.N
    S = segs.valid.shape[-1]
    n_wp = path.n_wp
    dev = path.x.device
    w = torch.arange(n_wp, device=dev)[:, None]
    offs = torch.arange(N, device=dev)[None, :]
    idxc = gather_waypoint_index(path, w + 1, offs)  # corridor stages
    idxs = gather_waypoint_index(path, w, offs)  # solver stages
    prev = torch.cat([idxc[:, :1], idxc[:, :-1]], 1)
    # trig in float64, rounded once: the table comes out the same on every
    # device, whatever its float32 cos/sin approximation (setup-only cost)
    psi_c, psi_p = path.psi.double()[idxc], path.psi.double()[prev]
    cols = [path.x[idxc], path.y[idxc], torch.cos(psi_c).float(),
            torch.sin(psi_c).float(), path.seg_dist[prev],
            torch.cos(psi_p).float(), torch.sin(psi_p).float(),
            segs.ub_xy[idxc].reshape(n_wp, N, 2 * S),
            segs.lb_xy[idxc].reshape(n_wp, N, 2 * S),
            segs.valid[idxc].to(torch.float32),
            path.v_ref[idxs], path.kappa[idxs], path.seg_dist[idxs]]
    cols = [c[..., None] if c.dim() == 2 else c for c in cols]
    return torch.cat(cols, -1).to(torch.float32).contiguous()


def gather_horizon_block(table: torch.Tensor, wp_id: torch.Tensor) -> torch.Tensor:
    """One contiguous-row take: (B,) base waypoint ids -> (B, N, F)."""
    return table[wp_id.long()]


def solver_inputs_from_block(blk: torch.Tensor, S: int):
    """(B, N, F) -> contiguous ``(v_ref, kappa_ref, delta_s)``, each (B, N)."""
    _, _, _, sol0, _ = _cols(S)
    return tuple(blk[..., sol0 + i].contiguous() for i in range(3))


def corridor_select_from_block(blk: torch.Tensor, cfg: MPCConfig,
                               safety_margin: float) -> Corridor:
    """Corridor continuity selection from a gathered window block — the
    dispatcher for kernel K2 (:mod:`.corridor_cuda`)."""
    return corridor_select(blk, cfg.max_segments, safety_margin)
