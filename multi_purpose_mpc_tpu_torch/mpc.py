"""LTV-MPC controller for a fleet (port of ``multi_purpose_mpc_tpu/mpc.py``).

One control step (reference: MPC.get_control, MPC.py:161-222) for all
lanes at once: locate each car on the path, take its horizon-table block,
select the corridor (kernel K2), assemble + solve the QP and compute the
violation floor (kernel K1), then accept the plan or replay the cached one.
Statuses, acceptance and replay are per-lane values, never exceptions.

:func:`mpc_step` is the single-lane step of the object API: the corridor
read from the live grid (kernels K4 and K2), then per-lane assembly and
kernel K3.

Per-lane cost weights (:class:`WeightSet`, a controller-tuning sweep)
assemble per-lane QPs here and solve them with kernel K3; the opt-in
escalation pass (:func:`escalate_rejects`) re-solves the worst rejected
lanes with K1 or K3.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch

from multi_purpose_mpc_tpu_torch.config import MPCConfig, ModelConfig
from multi_purpose_mpc_tpu_torch.models.bicycle import (
    CarState, horizon_indices, linearize, locate_waypoint, s2t, t2s)
from multi_purpose_mpc_tpu_torch.ops import admm
from multi_purpose_mpc_tpu_torch.ops.admm_cuda import (
    solve_ltv_qp_structured, solve_mpc_qp_fused)
from multi_purpose_mpc_tpu_torch.ops.constraints import (
    Corridor, SegmentCandidates, corridor_from_segments, update_path_constraints)
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
    corridor_select_from_block, gather_horizon_block, solver_inputs_from_block)
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import LTVQP, LTVSolution
from multi_purpose_mpc_tpu_torch.ops.path import PathData, gather_waypoint_index

_EPS = 1e-12


class WeightSet(NamedTuple):
    """Diagonal MPC cost weights as runtime data: path tracking,
    time-optimal driving and obstacle avoidance are weight choices on one
    controller (the reference's README.md:17-19).  With a leading fleet
    axis every lane runs a differently weighted controller in one rollout.

    Leaves: ``Q``/``QN`` (..., 3), ``R`` (..., 2) float tensors; ``None``
    means "use the :class:`MPCConfig` weights" for that leaf."""

    Q: Optional[torch.Tensor]  # (..., 3) running state cost diagonal
    R: Optional[torch.Tensor]  # (..., 2) input cost diagonal
    QN: Optional[torch.Tensor]  # (..., 3) terminal state cost diagonal


def weights_from_config(cfg: MPCConfig, device="cuda") -> WeightSet:
    """The config's static weights as a :class:`WeightSet` (no fleet axis),
    on the card unless the caller names another device."""
    f = lambda w: torch.tensor(w, dtype=torch.float32, device=device)
    return WeightSet(Q=f(cfg.Q), R=f(cfg.R), QN=f(cfg.QN))


@functools.lru_cache(maxsize=None)
def _const(vals: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(vals)`` on ``device``, made once per value and filled
    on the device: a copy from host data would sync the host, which a step
    captured in a CUDA graph must not (the cached tensor outlives the
    graph).  Callers share it and never write to it."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in vals])


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
                    kappa_pred, corridor: Corridor, horizon,
                    weights: Optional[WeightSet] = None) -> LTVQP:
    """Build the horizon QPs (MPC.py:61-155) from the gathered horizon data
    ``(v_ref, kappa_ref, delta_s)`` (each (B, N)) and the corridor.
    ``weights``: per-lane (B, 3|2) or shared (3|2,) cost diagonals; a
    ``None`` leaf falls back to the config's."""
    N = cfg.N
    v_ref, kappa_ref, delta_s = horizon
    Bsz = v_ref.shape[0]
    dt, dev = v_ref.dtype, v_ref.device
    vec = lambda vals: _const(tuple(vals), dt, dev)
    f, A, B = linearize(v_ref, kappa_ref, delta_s)

    ur = torch.stack([v_ref, kappa_ref], -1)  # (B, N, 2)
    # equality rhs: row 0 pins x0; row n+1 carries uq_n = B_n ur_n - f_n
    x0 = torch.stack([e_y, e_psi, torch.zeros_like(e_y)], -1)
    uq = torch.einsum("bnij,bnj->bni", B, ur) - f
    beq = torch.cat([-x0[:, None], uq], 1)

    base = WeightSet(*(_const(tuple(w), torch.float32, dev)
                       for w in (cfg.Q, cfg.R, cfg.QN)))
    w = base if weights is None else weights
    leaf = lambda a, b: (b if a is None else a).to(dt).reshape(-1, 1, b.shape[-1])
    Qd, QNd, Rd = leaf(w.Q, base.Q), leaf(w.QN, base.QN), leaf(w.R, base.R)
    P_x = torch.cat([Qd.expand(Bsz, N, 3), QNd.expand(Bsz, 1, 3)], 1)
    P_u = Rd.expand(Bsz, N, 2)
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


def mpc_pre_solve(state: CarState, cfg: MPCConfig, model: ModelConfig,
                  located, corridor: Corridor, horizon,
                  weights: Optional[WeightSet] = None):
    """Fleet work before a structured QP solve (MPC.py:172-180): assembly
    and violation floor from the located lanes, their corridor and their
    horizon data ``(v_ref, kappa_ref, delta_s)`` (each (B, N)).  Returns
    ``(qp, aux)``."""
    wp_id, e_y, e_psi = located
    kp = kappa_predictions(state.u_seq, cfg.N)
    qp = assemble_ltv_qp(cfg, model, e_y, e_psi, kp, corridor, horizon,
                         weights=weights)
    floor = corridor_violation_floor(e_y, e_psi, horizon, corridor, cfg, model)
    return qp, (wp_id, e_y, e_psi, corridor, floor)


def escalate_rejects(sol: LTVSolution, floor: torch.Tensor, feas_tol: float,
                     k: int, resolve) -> LTVSolution:
    """Second-chance solve for would-be-rejected lanes (the JAX package's
    ``escalate_rejects``): the ``k`` lanes with the largest acceptance
    margin ``r_prim - (feas_tol + floor)`` are re-solved by
    ``resolve(idx, warm) -> LTVSolution``, warm-started from the main
    solve's final iterate, and merged back wherever the margin was positive
    and the residual improved.

    Every field of the solution is merged, the warm-start carry included:
    that is what the JAX code does (``jax.tree.map(merge, sol, sub)``),
    although its docstring says the carry is not merged.

    The JAX code runs the pass under a ``lax.cond`` on "any margin > 0".
    Here it always runs on the top-k lanes: the merge mask makes it a no-op
    where nothing was rejected, and the step needs no device-to-host sync.
    At fleet scale some lane is rejected in almost every step, so the cond
    would fire anyway."""
    k = min(k, sol.r_prim.shape[0])
    if k <= 0:
        return sol
    margin = sol.r_prim - (feas_tol + floor)
    key = torch.where(margin > 0, margin, torch.full_like(margin, -math.inf))
    idx = torch.topk(key, k).indices
    sel = margin[idx] > 0
    sub = resolve(idx, sol.carry.take(idx))
    better = sel & (sub.r_prim < sol.r_prim[idx])

    def merge(a, b):
        out = a.clone()
        out[idx] = torch.where(better.reshape((-1,) + (1,) * (b.dim() - 1)),
                               b, a[idx])
        return out

    carry = type(sol.carry)(**{
        f.name: merge(getattr(sol.carry, f.name), getattr(sub.carry, f.name))
        for f in dataclasses.fields(sol.carry)})
    return LTVSolution(X=merge(sol.X, sub.X), U=merge(sol.U, sub.U),
                       status=merge(sol.status, sub.status),
                       r_prim=merge(sol.r_prim, sub.r_prim),
                       r_dual=merge(sol.r_dual, sub.r_dual), carry=carry)


def _escalated_cfg(solver_cfg):
    """Escalation budget: ``escalate_rho_updates`` more adapted-rho rounds
    from the main solve's warm iterate, resuming its rho, no polish (the
    JAX package's ``_escalated_cfg``: the pass brings a just-above-tolerance
    residual into the production accuracy class, it does not converge the
    QP)."""
    return dataclasses.replace(solver_cfg,
                               rho_updates=solver_cfg.escalate_rho_updates,
                               carry_rho=True, escalate_lanes=0,
                               polish_iters=0)


def mpc_step_batched_with_corridor(state: CarState, cfg: MPCConfig,
                                   model: ModelConfig, located,
                                   corridor: Corridor, horizon,
                                   weights: Optional[WeightSet] = None,
                                   ) -> ControlOutput:
    """Fleet control step given the corridor and the horizon data
    ``(v_ref, kappa_ref, delta_s)`` (each (B, N)): the entry of callers
    that select corridors themselves, e.g. the dynamic-grid rollout.

    No ``weights``: fused assembly + ADMM + floor, kernel K1.  Per-lane
    ``weights``: per-lane assembly here, then kernel K3 (K1 bakes the
    config's weights).  ``cfg.solver.escalate_lanes > 0`` adds the
    escalation pass, through the same kernel."""
    wp_id, e_y, e_psi = located
    esc = _escalated_cfg(cfg.solver)
    if weights is not None:
        qp, aux = mpc_pre_solve(state, cfg, model, located, corridor, horizon,
                                weights)
        sol = solve_ltv_qp_structured(qp, state.solver, cfg.solver)

        def resolve(idx, warm):
            return solve_ltv_qp_structured(qp.take(idx), warm, esc)
    else:
        v_ref, kappa_ref, delta_s = horizon
        x0 = torch.stack([e_y, e_psi, torch.zeros_like(e_y)], -1)
        kp = kappa_predictions(state.u_seq, cfg.N)
        sol, floor = solve_mpc_qp_fused(v_ref, kappa_ref, delta_s,
                                        corridor.lb, corridor.ub, x0, kp,
                                        state.solver, cfg.solver, cfg, model)
        aux = (wp_id, e_y, e_psi, corridor, floor)

        def resolve(idx, warm):
            return solve_mpc_qp_fused(
                v_ref[idx], kappa_ref[idx], delta_s[idx], corridor.lb[idx],
                corridor.ub[idx], x0[idx], kp[idx], warm, esc, cfg, model)[0]
    if cfg.solver.escalate_lanes > 0:
        sol = escalate_rejects(sol, aux[4], cfg.feas_tol,
                               cfg.solver.escalate_lanes, resolve)
    return mpc_post_solve(state, sol, aux, cfg, model)


def mpc_step_batched(state: CarState, path: PathData, cfg: MPCConfig,
                     model: ModelConfig, table: torch.Tensor,
                     weights: Optional[WeightSet] = None) -> ControlOutput:
    """Fleet control step through the windowed horizon table
    (:mod:`.ops.horizon_table`): one block take, corridor selection (K2),
    then the solve of :func:`mpc_step_batched_with_corridor` fed from the
    block (K1, or per-lane assembly + K3 under ``weights``)."""
    located = mpc_locate(state, path)
    blk = gather_horizon_block(table, located[0])
    corridor = corridor_select_from_block(blk, cfg, model.safety_margin)
    horizon = solver_inputs_from_block(blk, cfg.max_segments)
    return mpc_step_batched_with_corridor(state, cfg, model, located,
                                          corridor, horizon, weights=weights)


def mpc_step(state: CarState, path: PathData, grid: GridMap, cfg: MPCConfig,
             model: ModelConfig,
             segments: Optional[SegmentCandidates] = None) -> ControlOutput:
    """One control step (MPC.get_control, MPC.py:161-222) on the grid as it
    is now: locate, corridor, horizon gather, assembly and violation floor
    (:func:`mpc_pre_solve`), solve, accept or replay
    (:func:`mpc_post_solve`).  The state has a batch axis (1 for the
    object API's car); no escalation pass runs.

    The corridor is :func:`~.ops.constraints.update_path_constraints` from
    ``wp_id + 1`` on ``grid`` (kernels K4 and K2 on the card), or, given
    the static-grid ``segments`` of every waypoint, the selection from
    them.  The solve is :func:`~.ops.admm_cuda.solve_ltv_qp_structured`
    (kernel K3 on the card), the TPU entry ``solve_ltv_qp_pallas`` where
    the JAX function calls its XLA solver: the step size resumes from the
    carry and ``eps_d`` comes from max(|q_x|, |q_u|)."""
    located = mpc_locate(state, path)
    wp_id = located[0]
    sm = model.safety_margin
    if segments is None:
        corridor = update_path_constraints(
            grid, path, wp_id + 1, cfg.N, 2.0 * sm, sm,
            n_samples=cfg.n_scan_samples, max_segments=cfg.max_segments)
    else:
        corridor = mpc_corridor(wp_id, path, cfg, model, segments)
    idx = horizon_indices(path, wp_id, cfg.N)
    horizon = (path.v_ref[idx], path.kappa[idx], path.seg_dist[idx])
    qp, aux = mpc_pre_solve(state, cfg, model, located, corridor, horizon)
    sol = solve_ltv_qp_structured(qp, state.solver, cfg.solver)
    return mpc_post_solve(state, sol, aux, cfg, model)


def predict_world_positions(path: PathData, wp_id, X_pred: torch.Tensor):
    """World x / y (B, N+1) of the predicted spatial states ``X_pred``
    (B, N+1, 3) along the horizon from ``wp_id`` (B,) (MPC.py:224-248,
    all N+1 points)."""
    N = X_pred.shape[-2] - 1
    offs = torch.arange(N + 1, device=X_pred.device)
    idx = gather_waypoint_index(path, wp_id.long()[:, None], offs[None, :])
    x, y, _ = s2t(path, idx, X_pred[..., 0], X_pred[..., 1])
    return x, y
