"""LTV-MPC controller for a fleet (port of ``multi_purpose_mpc_tpu/mpc.py``).

One control step (reference: MPC.get_control, MPC.py:161-222) for all
lanes at once: locate each car on the path, take its horizon-table block,
select the corridor (kernel K2), assemble + solve the QP and compute the
violation floor (kernel K1), then accept the plan or replay the cached one.
Statuses, acceptance and replay are per-lane values, never exceptions.

Only the static-grid horizon-table path is ported; per-lane weight sweeps
(``WeightSet``) and the escalation pass come later.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from multi_purpose_mpc_tpu_torch.config import MPCConfig, ModelConfig
from multi_purpose_mpc_tpu_torch.models.bicycle import (
    CarState, linearize, locate_waypoint, t2s)
from multi_purpose_mpc_tpu_torch.ops import admm
from multi_purpose_mpc_tpu_torch.ops.admm_cuda import solve_mpc_qp_fused
from multi_purpose_mpc_tpu_torch.ops.constraints import (
    Corridor, SegmentCandidates, corridor_from_segments)
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
    corridor_select_from_block, gather_horizon_block, solver_inputs_from_block)
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import LTVQP, LTVSolution
from multi_purpose_mpc_tpu_torch.ops.path import PathData

_EPS = 1e-12


class ControlOutput(NamedTuple):
    state: CarState  # updated controller-side state (wp_id, e_y, u_seq, flags)
    v: torch.Tensor  # (B,) speed command
    delta: torch.Tensor  # (B,) steering command
    status: torch.Tensor  # (B,) solver status for this step
    ok: torch.Tensor  # (B,) bool — control accepted (vs replayed)
    r_prim: torch.Tensor  # (B,) QP primal residual
    floor: torch.Tensor  # (B,) certified violation floor (0 = QP feasible)
    corridor: Corridor  # horizon corridor
    X_pred: torch.Tensor  # (B, N+1, 3) predicted spatial states


def assemble_ltv_qp(cfg: MPCConfig, model: ModelConfig, e_y, e_psi,
                    kappa_pred, corridor: Corridor, horizon) -> LTVQP:
    """Build the horizon QPs (MPC.py:61-155) from the gathered horizon data
    ``(v_ref, kappa_ref, delta_s)`` (each (B, N)) and the corridor."""
    N = cfg.N
    v_ref, kappa_ref, delta_s = horizon
    Bsz = v_ref.shape[0]
    dt, dev = v_ref.dtype, v_ref.device
    vec = lambda vals: torch.tensor(vals, dtype=dt, device=dev)
    f, A, B = linearize(v_ref, kappa_ref, delta_s)

    ur = torch.stack([v_ref, kappa_ref], -1)  # (B, N, 2)
    # equality rhs: row 0 pins x0; row n+1 carries uq_n = B_n ur_n - f_n
    x0 = torch.stack([e_y, e_psi, torch.zeros_like(e_y)], -1)
    uq = torch.einsum("bnij,bnj->bni", B, ur) - f
    beq = torch.cat([-x0[:, None], uq], 1)

    P_x = torch.cat([vec(cfg.Q).expand(Bsz, N, 3),
                     vec(cfg.QN).expand(Bsz, 1, 3)], 1)
    P_u = vec(cfg.R).expand(Bsz, N, 2)
    # state reference: corridor centre-line e_y for steps 1..N (MPC.py:124-125)
    xr = torch.zeros((Bsz, N + 1, 3), dtype=dt, device=dev)
    xr[:, 1:, 0] = (corridor.lb + corridor.ub) / 2.0
    q_x = -P_x * xr
    q_u = -P_u * ur

    # bounds: state box, e_y corridor on steps 1..N, x0's e_y pinned
    lx = vec(cfg.xmin).expand(Bsz, N + 1, 3).clone()
    ux = vec(cfg.xmax).expand(Bsz, N + 1, 3).clone()
    lx[:, 0, 0] = e_y
    ux[:, 0, 0] = e_y
    lx[:, 1:, 0] = corridor.lb
    ux[:, 1:, 0] = corridor.ub

    # inputs: v in [v_min, min(v_max, sqrt(ay_max/|kappa_pred|))], |kappa| <= kmax
    kappa_max = cfg.kappa_max(model.length)
    vmax_dyn = torch.clamp(torch.sqrt(cfg.ay_max / (kappa_pred.abs() + _EPS)),
                           max=cfg.v_max)
    lu = vec([cfg.v_min, -kappa_max]).expand(Bsz, N, 2)
    uu = torch.stack([vmax_dyn, torch.full_like(vmax_dyn, kappa_max)], -1)
    return LTVQP(A=A, B=B, beq=beq, q_x=q_x, q_u=q_u, P_x=P_x, P_u=P_u,
                 lx=lx, ux=ux, lu=lu, uu=uu)


def violation_floor(e_y, e_psi, kappa_ref, delta_s, lb, ub,
                    kappa_max: float) -> torch.Tensor:
    """Certified lower bound (B,) on the corridor violation every
    dynamics-consistent horizon trajectory incurs, by interval reachability
    of (e_y, e_psi) under unconstrained curvature input: a positive floor
    means the QP is structurally infeasible from the measured state."""
    y_lo = y_hi = e_y
    p_lo = p_hi = e_psi
    floor = torch.zeros_like(e_y)
    for n in range(kappa_ref.shape[1]):
        k_ref, ds = kappa_ref[:, n], delta_s[:, n]
        # e_y(n+1) = e_y(n) + ds * e_psi(n)
        ny_lo = y_lo + ds * p_lo
        ny_hi = y_hi + ds * p_hi
        # e_psi(n+1) = -k_ref^2 ds e_y(n) + e_psi(n) + ds (u_k - k_ref)
        c = -(k_ref * k_ref) * ds
        t_lo = torch.minimum(c * y_lo, c * y_hi)
        t_hi = torch.maximum(c * y_lo, c * y_hi)
        np_lo = t_lo + p_lo + ds * (-kappa_max - k_ref)
        np_hi = t_hi + p_hi + ds * (kappa_max - k_ref)
        viol = torch.clamp(torch.maximum(lb[:, n] - ny_hi, ny_lo - ub[:, n]),
                           min=0.0)
        floor = torch.maximum(floor, viol)
        y_lo, y_hi, p_lo, p_hi = ny_lo, ny_hi, np_lo, np_hi
    return floor


def corridor_violation_floor(e_y, e_psi, horizon, corridor: Corridor,
                             cfg: MPCConfig, model: ModelConfig):
    """:func:`violation_floor`, gated to 0 where the corridor collapsed
    somewhere (ub == lb == 0, the reference's blocked-path signal)."""
    _, kappa_ref, delta_s = horizon
    floor = violation_floor(e_y, e_psi, kappa_ref, delta_s, corridor.lb,
                            corridor.ub, cfg.kappa_max(model.length))
    width_ok = ((corridor.ub - corridor.lb) > 0.0).all(1)
    return torch.where(width_ok, floor, torch.zeros_like(floor))


def kappa_predictions(u_seq: torch.Tensor, N: int) -> torch.Tensor:
    """(B, N) predicted curvature: the previous kappa sequence shifted one
    step, last entry repeated (intended semantics of MPC.py:86-87)."""
    kappa_prev = u_seq.reshape(-1, N, 2)[:, :, 1]
    idx = torch.clamp(torch.arange(N, device=u_seq.device) + 1, max=N - 1)
    return kappa_prev[:, idx]


def mpc_locate(state: CarState, path: PathData):
    """Localization + frame transform (MPC.py:172-177)."""
    wp_id = locate_waypoint(path, state.s)
    e_y, e_psi = t2s(path, wp_id, state.x, state.y, state.psi)
    return wp_id, e_y, e_psi


def mpc_corridor(wp_id, path: PathData, cfg: MPCConfig, model: ModelConfig,
                 segments: SegmentCandidates) -> Corridor:
    """Corridor from the precomputed static-grid segments (MPC.py:116-118
    passes ``wp_id + 1``)."""
    return corridor_from_segments(path, segments, wp_id + 1, cfg.N,
                                  model.safety_margin)


def mpc_post_solve(state: CarState, sol: LTVSolution, aux,
                   cfg: MPCConfig, model: ModelConfig) -> ControlOutput:
    """Acceptance, control extraction, infeasibility replay and state
    update (MPC.py:183-222)."""
    N = cfg.N
    Bsz = state.batch
    wp_id, e_y, e_psi, corridor, floor = aux

    # finite solutions within the feasibility tolerance are used; others
    # replay the cached sequence (optionally relaxed by the certified floor)
    floor_eff = floor if cfg.least_violation_accept else torch.zeros_like(floor)
    ok = (sol.status != admm.DIVERGED) & (sol.r_prim <= cfg.feas_tol + floor_eff)

    u_seq_new = torch.where(ok[:, None], sol.U.reshape(Bsz, -1), state.u_seq)
    replay_idx = torch.clamp(state.infeasibility_count + 1, max=N - 1).long()
    u_replay = state.u_seq.reshape(Bsz, N, 2)[
        torch.arange(Bsz, device=ok.device), replay_idx]
    v = torch.where(ok, sol.U[:, 0, 0], u_replay[:, 0])
    kappa = torch.where(ok, sol.U[:, 0, 1], u_replay[:, 1])
    delta = torch.atan(kappa * model.length)  # kappa -> steering (MPC.py:188-189)

    # done lanes idle in place without accumulating failures
    count = state.infeasibility_count
    infeas = torch.where(ok, torch.zeros_like(count), count + 1).to(torch.int32)
    infeas = torch.where(state.done, count, infeas)
    failed = state.failed | ((infeas >= N - 1) & ~state.done)

    new_state = dataclasses.replace(state, wp_id=wp_id, e_y=e_y, e_psi=e_psi,
                                    u_seq=u_seq_new, solver=sol.carry,
                                    infeasibility_count=infeas, failed=failed)
    return ControlOutput(state=new_state, v=v, delta=delta, status=sol.status,
                         ok=ok, r_prim=sol.r_prim, floor=floor,
                         corridor=corridor, X_pred=sol.X)


def mpc_step_batched(state: CarState, path: PathData, cfg: MPCConfig,
                     model: ModelConfig, table: torch.Tensor) -> ControlOutput:
    """Fleet control step through the windowed horizon table
    (:mod:`.ops.horizon_table`): one block take, corridor selection (K2),
    fused assembly + ADMM + floor (K1), acceptance/replay."""
    if cfg.solver.escalate_lanes > 0:
        raise NotImplementedError("the escalation pass is not ported yet")
    wp_id, e_y, e_psi = mpc_locate(state, path)
    blk = gather_horizon_block(table, wp_id)
    corridor = corridor_select_from_block(blk, cfg, model.safety_margin)
    v_ref, kappa_ref, delta_s = solver_inputs_from_block(blk, cfg.max_segments)
    x0 = torch.stack([e_y, e_psi, torch.zeros_like(e_y)], -1)
    kp = kappa_predictions(state.u_seq, cfg.N)
    sol, floor = solve_mpc_qp_fused(v_ref, kappa_ref, delta_s, corridor.lb,
                                    corridor.ub, x0, kp, state.solver,
                                    cfg.solver, cfg, model)
    return mpc_post_solve(state, sol, (wp_id, e_y, e_psi, corridor, floor),
                          cfg, model)
