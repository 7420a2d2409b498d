"""The controller's fixed-budget QP solve, dense, in float64.

The configuration fixes the solver's algorithm and budget, and with a zero
curvature weight the budget is part of the controller's answer: the
converged plan is not what the controller drives.  So the reference runs
the same algorithm, OSQP's ADMM on the horizon QP (equality rows weighted
by ``rho_eq_scale``, rows with l = u too, over-relaxation ``alpha``), for
``rho_updates`` rounds of ``iterations`` iterations, each round ending in
the residual-balancing step-size update, then ``polish_iters`` iterations
with the step size of the rows at a bound raised ``polish_boost`` times,
kept where they lower the primal residual; from the warm start carried by
the previous step.  Here every KKT system is formed whole and solved by a
dense Cholesky factorisation; the variables are x_0 .. x_N (e_y, e_psi,
t), then u_0 .. u_{N-1} (v, kappa)."""

from __future__ import annotations

import dataclasses
import math

import torch

SOLVED, MAX_ITER, DIVERGED = 0, 1, 2


@dataclasses.dataclass
class QP:
    """min 1/2 z' diag(Pd) z + q'z, Aeq z = beq, lo <= z <= hi; (L, ...)."""

    Pd: torch.Tensor
    q: torch.Tensor
    Aeq: torch.Tensor
    beq: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


@dataclasses.dataclass
class Carry:
    """The ADMM iterate a step hands the next one: z, the box copy zb, the
    duals of the equality and box rows, and the step size."""

    z: torch.Tensor
    zb: torch.Tensor
    yeq: torch.Tensor
    yb: torch.Tensor
    rho: torch.Tensor


def fresh(L: int, N: int, rho: float, device, dtype=torch.float64) -> Carry:
    n, m = 3 * (N + 1) + 2 * N, 3 * (N + 1)
    z = lambda k: torch.zeros((L, k), dtype=dtype, device=device)
    return Carry(z(n), z(n), z(m), z(n),
                 torch.full((L,), rho, dtype=dtype, device=device))


def horizon_qp(mpc: dict, kmax: float, e_y, e_psi, v, kappa, ds, lb, ub,
               kappa_pred) -> QP:
    """The horizon QP of L lanes from the measured (e_y, e_psi), the
    horizon's (v_ref, kappa_ref, ds) and corridor (lb, ub) (L, N) and the
    predicted curvature (the carried plan's, shifted)."""
    L, N = v.shape
    dt, dev = v.dtype, v.device
    nx = 3 * (N + 1)
    n = nx + 2 * N
    z0 = torch.zeros_like(v)
    A = torch.stack([torch.stack([z0 + 1, ds, z0], -1),
                     torch.stack([-(kappa * kappa) * ds, z0 + 1, z0], -1),
                     torch.stack([-(kappa / v) * ds, z0, z0 + 1], -1)], -2)
    Bm = torch.stack([torch.stack([z0, z0], -1), torch.stack([z0, ds], -1),
                      torch.stack([-ds / (v * v), z0], -1)], -2)
    Aeq = torch.zeros((L, nx, n), dtype=dt, device=dev)
    eye = torch.eye(3, dtype=dt, device=dev)
    for i in range(N + 1):
        Aeq[:, 3 * i:3 * i + 3, 3 * i:3 * i + 3] = -eye
    for k in range(N):
        r = 3 * (k + 1)
        Aeq[:, r:r + 3, 3 * k:3 * k + 3] += A[:, k]
        Aeq[:, r:r + 3, nx + 2 * k:nx + 2 * k + 2] = Bm[:, k]
    # B_k (v_k, kappa_k) - f_k = (0, ds kappa, -2 ds / v)
    uq = torch.stack([z0, ds * kappa, -2.0 * ds / v], -1)
    beq = torch.cat([-torch.stack([e_y, e_psi, z0[:, 0]], -1),
                     uq.reshape(L, -1)], 1)
    c = lambda key: torch.tensor(mpc[key], dtype=dt, device=dev)
    Q, QN, R = c("Q"), c("QN"), c("R")
    Pd = torch.cat([Q.repeat(N), QN, R.repeat(N)]).expand(L, n)
    ctr = (lb + ub) / 2
    qx = torch.zeros((L, N + 1, 3), dtype=dt, device=dev)
    qx[:, 1:N, 0] = -Q[0] * ctr[:, :-1]
    qx[:, N, 0] = -QN[0] * ctr[:, -1]
    qu = torch.stack([-R[0] * v, -R[1] * kappa], -1)
    q = torch.cat([qx.reshape(L, -1), qu.reshape(L, -1)], 1)
    lo = torch.full((L, n), -math.inf, dtype=dt, device=dev)
    hi = torch.full((L, n), math.inf, dtype=dt, device=dev)
    xlo, xhi = torch.tensor(mpc["xmin"] if "xmin" in mpc else [-math.inf] * 3,
                            dtype=dt), torch.tensor(
        mpc["xmax"] if "xmax" in mpc else [math.inf] * 3, dtype=dt)
    for j in range(3):
        lo[:, j:nx:3], hi[:, j:nx:3] = float(xlo[j]), float(xhi[j])
    lo[:, 0], hi[:, 0] = e_y, e_y
    lo[:, 3:nx:3], hi[:, 3:nx:3] = lb, ub
    vmax = torch.clamp(torch.sqrt(mpc["ay_max"] / (kappa_pred.abs() + 1e-12)),
                       max=mpc["v_max"])
    lo[:, nx::2], hi[:, nx::2] = mpc["v_min"], vmax
    lo[:, nx + 1::2], hi[:, nx + 1::2] = -kmax, kmax
    return QP(Pd, q, Aeq, beq, lo, hi)


def _amax(t):
    return t.abs().amax(1)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def primal_residual(qp: QP, z):
    viol = (qp.lo - z).clamp(min=0) + (z - qp.hi).clamp(min=0)
    return torch.maximum(_amax(_mv(qp.Aeq, z) - qp.beq), viol.amax(1))


def dual_residual(qp: QP, z, yeq, yb):
    g = _mv(qp.Aeq.transpose(1, 2), yeq)
    return _amax(qp.Pd * z + qp.q + g + yb), g


def solve(qp: QP, carry: Carry, s: dict):
    """The fixed-budget solve from ``carry`` with the solver settings
    ``s``: ``(new carry, r_prim, r_dual)``."""
    sigma, alpha, eq_scale = s["sigma"], s["alpha"], s["rho_eq_scale"]
    AeqT = qp.Aeq.transpose(1, 2)
    AtA = AeqT @ qp.Aeq
    is_eq = (qp.hi - qp.lo) < 1e-9
    z, yeq, yb = carry.z, carry.yeq, carry.yb
    zb = torch.maximum(torch.minimum(carry.zb, qp.hi), qp.lo)

    def run(iters, rho, state, boost=None):
        z, zb, yeq, yb = state
        r_eq = (rho * eq_scale)[:, None]
        r_b = torch.where(is_eq, r_eq, rho[:, None])
        if boost is not None:
            r_b = r_b * boost
        M = torch.diag_embed(qp.Pd + sigma + r_b) + r_eq[..., None] * AtA
        Lc = torch.linalg.cholesky(M)
        for _ in range(iters):
            rhs = sigma * z - qp.q + _mv(AeqT, r_eq * qp.beq - yeq) \
                + r_b * zb - yb
            zt = torch.cholesky_solve(rhs[..., None], Lc)[..., 0]
            req = _mv(qp.Aeq, zt)
            z = alpha * zt + (1 - alpha) * z
            yeq = yeq + r_eq * (alpha * req + (1 - alpha) * qp.beq - qp.beq)
            zb_pre = alpha * zt + (1 - alpha) * zb
            zb_new = torch.maximum(torch.minimum(zb_pre + yb / r_b, qp.hi),
                                   qp.lo)
            yb = yb + r_b * (zb_pre - zb_new)
            zb = zb_new
        return z, zb, yeq, yb

    rho = carry.rho
    state = (z, zb, yeq, yb)
    for _ in range(max(s["rho_updates"], 1)):
        state = run(s["iterations"], rho, state)
        z, zb, yeq, yb = state
        req = _mv(qp.Aeq, z)
        rp = torch.maximum(_amax(req - qp.beq), _amax(z - zb))
        rd, g = dual_residual(qp, z, yeq, yb)
        den_p = torch.maximum(_amax(req), _amax(z))
        den_d = torch.maximum(torch.maximum(_amax(qp.Pd * z), _amax(qp.q)),
                              _amax(g).clamp(min=1e-10))
        ratio = torch.sqrt((rp / den_p.clamp(min=1e-10))
                           / (rd / den_d).clamp(min=1e-12))
        new = torch.clamp(rho * ratio, 1e-6, 1e6)
        rho = torch.where(torch.isfinite(new), new, rho)
    if s["polish_iters"] > 0:
        z, zb, yeq, yb = state
        at_lo = zb <= qp.lo + 1e-4
        act = (at_lo | (zb >= qp.hi - 1e-4)) & torch.isfinite(
            torch.where(at_lo, qp.lo, qp.hi))
        boost = torch.where(act, s["polish_boost"], 1.0).to(z.dtype)
        pol = run(s["polish_iters"], rho, state, boost)
        take = (primal_residual(qp, pol[0]) < primal_residual(qp, z))[:, None]
        state = tuple(torch.where(take, p, m) for p, m in zip(pol, state))
    z, zb, yeq, yb = state
    rd, _ = dual_residual(qp, z, yeq, yb)
    return Carry(z, zb, yeq, yb, rho), primal_residual(qp, z), rd


def status(carry: Carry, rp, rd, qmax, s: dict):
    """SOLVED / MAX_ITER / DIVERGED of a solve, and its carry with a
    non-finite lane's replaced by a fresh one."""
    finite = torch.isfinite(carry.z).all(1)
    eps_p = s["eps_abs"] + s["eps_rel"] * _amax(carry.z)
    eps_d = s["eps_abs"] + s["eps_rel"] * qmax
    st = torch.where(~finite, DIVERGED,
                     torch.where((rp <= eps_p) & (rd <= eps_d), SOLVED,
                                 MAX_ITER))
    L = carry.z.shape[0]
    N = (carry.z.shape[1] - 3) // 5
    f = fresh(L, N, s["rho"], carry.z.device, carry.z.dtype)
    keep = lambda a, b: torch.where(
        finite.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return st, Carry(*(keep(getattr(carry, k.name), getattr(f, k.name))
                       for k in dataclasses.fields(Carry)))
