"""Dense OSQP-algorithm ADMM (port of ``ops/admm.py``).

    minimize   1/2 z' P z + q' z   subject to  l <= A z <= u

with Ruiz equilibration, cost scaling, sigma-regularized reduced-KKT
iterations, over-relaxation and adaptive rho with a refactorization per
round.  Fixed iteration counts; convergence is a status value.  Only the
speed-profile QP (setup, once per path) uses this dense solver.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from multi_purpose_mpc_tpu_torch.config import SolverConfig

# Status codes (per-lane values, never exceptions)
SOLVED = 0
MAX_ITER = 1
DIVERGED = 2

_RHO_MIN = 1e-6
_RHO_MAX = 1e6


class ADMMResult(NamedTuple):
    x: torch.Tensor  # (n,) primal solution
    z: torch.Tensor  # (m,) constraint-space solution
    y: torch.Tensor  # (m,) dual solution
    status: torch.Tensor  # () int32
    r_prim: torch.Tensor  # () primal residual (inf-norm, unscaled)
    r_dual: torch.Tensor  # () dual residual (inf-norm, unscaled)


def _inf_norm(v, dim=None):
    return v.abs().amax() if dim is None else v.abs().amax(dim=dim)


def ruiz_equilibrate(P, q, A, iters: int = 10):
    """Ruiz equilibration of [[P, A'], [A, 0]] plus OSQP's cost scaling.
    Returns ``(c D P D, c D q, E A D, d, e, c)``."""
    d = torch.ones(P.shape[0], dtype=P.dtype, device=P.device)
    e = torch.ones(A.shape[0], dtype=P.dtype, device=P.device)
    for _ in range(iters):
        Ps = d[:, None] * P * d[None, :]
        As = e[:, None] * A * d[None, :]
        cn = torch.maximum(_inf_norm(Ps, 0), _inf_norm(As, 0))
        rn = _inf_norm(As, 1)
        d = d / torch.sqrt(torch.where(cn > 0, cn, torch.ones_like(cn)))
        e = e / torch.sqrt(torch.where(rn > 0, rn, torch.ones_like(rn)))
    Pb = d[:, None] * P * d[None, :]
    Ab = e[:, None] * A * d[None, :]
    qb = d * q
    denom = torch.maximum(_inf_norm(Pb, 0).mean(), _inf_norm(qb))
    c = 1.0 / torch.clamp(denom, 1e-6, 1e6)
    return c * Pb, c * qb, Ab, d, e, c


def admm_solve(P, q, A, l, u, cfg: SolverConfig,
               x0: Optional[torch.Tensor] = None,
               y0: Optional[torch.Tensor] = None) -> ADMMResult:
    """Solve one dense QP: ``cfg.rho_updates`` rounds of ``cfg.iterations``
    ADMM iterations, rho adapting between rounds."""
    n = q.shape[0]
    dt, dev = q.dtype, q.device
    sigma, alpha = cfg.sigma, cfg.alpha

    if cfg.scaling_iters > 0:
        Pb, qb, Ab, d, e, c = ruiz_equilibrate(P, q, A, cfg.scaling_iters)
        lb, ub = e * l, e * u
    else:
        Pb, qb, Ab, lb, ub = P, q, A, l, u
        d = torch.ones(n, dtype=dt, device=dev)
        e = torch.ones(A.shape[0], dtype=dt, device=dev)
        c = torch.ones((), dtype=dt, device=dev)
    inf = torch.full_like(lb, float("inf"))
    lb = torch.where(torch.isneginf(l), -inf, lb)
    ub = torch.where(torch.isposinf(u), inf, ub)

    x = torch.zeros(n, dtype=dt, device=dev) if x0 is None else x0 / d
    y = torch.zeros_like(lb) if y0 is None else y0 * c / e
    z = torch.minimum(torch.maximum(Ab @ x, lb), ub)
    is_eq = (ub - lb) < 1e-9
    eye = torch.eye(n, dtype=dt, device=dev)

    rho_s = torch.tensor(cfg.rho, dtype=dt, device=dev)
    for _ in range(max(cfg.rho_updates, 1)):
        rho = torch.where(is_eq, rho_s * cfg.rho_eq_scale, rho_s)
        L = torch.linalg.cholesky(Pb + sigma * eye + (Ab.T * rho) @ Ab)
        for _ in range(cfg.iterations):
            rhs = sigma * x - qb + Ab.T @ (rho * z - y)
            x_t = torch.cholesky_solve(rhs[:, None], L)[:, 0]
            z_t = Ab @ x_t
            x = alpha * x_t + (1.0 - alpha) * x
            z_pre = alpha * z_t + (1.0 - alpha) * z
            z_n = torch.minimum(torch.maximum(z_pre + y / rho, lb), ub)
            y = y + rho * (z_pre - z_n)
            z = z_n
        # adaptive rho from scaled relative residuals (OSQP §5.2)
        Ax, Px, Aty = Ab @ x, Pb @ x, Ab.T @ y
        rp = _inf_norm(Ax - z) / torch.clamp(
            torch.maximum(_inf_norm(Ax), _inf_norm(z)), min=1e-10)
        rd = _inf_norm(Px + qb + Aty) / torch.clamp(torch.maximum(
            _inf_norm(Px), torch.maximum(_inf_norm(qb), _inf_norm(Aty))), min=1e-10)
        ratio = torch.sqrt(rp / torch.clamp(rd, min=1e-12))
        rho_new = torch.clamp(rho_s * ratio, _RHO_MIN, _RHO_MAX)
        rho_s = torch.where(torch.isfinite(rho_new), rho_new, rho_s)

    x_u, y_u, z_u = d * x, e * y / c, z / e
    Ax, Px, Aty = A @ x_u, P @ x_u, A.T @ y_u
    r_prim = _inf_norm(Ax - z_u)
    r_dual = _inf_norm(Px + q + Aty)
    eps_p = cfg.eps_abs + cfg.eps_rel * torch.maximum(_inf_norm(Ax), _inf_norm(z_u))
    eps_d = cfg.eps_abs + cfg.eps_rel * torch.maximum(
        torch.maximum(_inf_norm(Px), _inf_norm(q)), _inf_norm(Aty))
    finite = torch.isfinite(x_u).all() & torch.isfinite(y_u).all()
    converged = (r_prim <= eps_p) & (r_dual <= eps_d)
    status = torch.where(~finite, DIVERGED,
                         torch.where(converged, SOLVED, MAX_ITER)).to(torch.int32)
    return ADMMResult(x=x_u, z=z_u, y=y_u, status=status, r_prim=r_prim,
                      r_dual=r_dual)
