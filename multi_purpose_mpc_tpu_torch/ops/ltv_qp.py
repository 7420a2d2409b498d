"""Structured ADMM solver for the horizon-N LTV-MPC QP (port of ``ops/ltv_qp.py``).

    variables  z = [x_0..x_N | u_0..u_{N-1}],  nx = 3, nu = 2
    equality   -x_0 = -x0_meas;  A_n x_n + B_n u_n - x_{n+1} = uq_n
    inequality identity bounds on every variable
    cost       diagonal P, linear q

Variables are grouped per stage w_n = (x_n, u_n) in R^5; the u-slot of
stage N is a pad variable with zero cost and (-inf, inf) bounds.  The ADMM
reduced KKT matrix is then block tridiagonal with 5x5 blocks, factorized by
a Schur-complement recursion over the N+1 stages; every iteration runs one
forward and one backward substitution.  ``SolverConfig(stage_solver="cr")``
factors and solves the same system by block cyclic reduction instead
(:mod:`.cyclic_reduction`) in :func:`admm_rounds`, the core of kernels K1
and K3.

The solver core works on the stage layout of the fused TPU kernel
(``StageQP``: ``[A_n | B_n]``, beq, Pd, qv, lw, uw per stage) and follows
that kernel's arithmetic operation for operation: every sum runs left to
right over the same terms, and the 5x5 inverses are Gauss-Jordan without
pivoting.  The CUDA kernel ``csrc/admm_fused.cu`` mirrors it line for line
(built without FMA contraction), which is what lets the plain version serve
as its twin (:mod:`.admm_cuda`).  Every tensor carries a leading fleet
axis B; stage recursions are Python loops over (B, 5, 5) tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from multi_purpose_mpc_tpu_torch.config import SolverConfig
from multi_purpose_mpc_tpu_torch.ops import admm as admm_mod

NX = 3
NU = 2
NW = NX + NU  # stage width


@dataclasses.dataclass
class LTVQP:
    """A batch of LTV-MPC QPs (leading axis B on every field)."""

    A: torch.Tensor  # (B, N, 3, 3) stage transition
    B: torch.Tensor  # (B, N, 3, 2) stage input
    beq: torch.Tensor  # (B, N+1, 3) equality rhs: [-x0_meas, uq_0..uq_{N-1}]
    q_x: torch.Tensor  # (B, N+1, 3) linear cost on states
    q_u: torch.Tensor  # (B, N, 2) linear cost on inputs
    P_x: torch.Tensor  # (B, N+1, 3) diagonal quadratic cost on states
    P_u: torch.Tensor  # (B, N, 2) diagonal quadratic cost on inputs
    lx: torch.Tensor  # (B, N+1, 3) state lower bounds
    ux: torch.Tensor  # (B, N+1, 3) state upper bounds
    lu: torch.Tensor  # (B, N, 2) input lower bounds
    uu: torch.Tensor  # (B, N, 2) input upper bounds

    @property
    def N(self) -> int:
        return self.B.shape[-3]

    def take(self, idx) -> "LTVQP":
        """The QPs of lanes ``idx``."""
        return _take(self, idx)


@dataclasses.dataclass
class StageQP:
    """The same QPs in the per-stage layout the solver core runs on."""

    AB: torch.Tensor  # (B, N, 3, 5) [A_n | B_n]
    beq: torch.Tensor  # (B, N+1, 3)
    Pd: torch.Tensor  # (B, N+1, 5) diagonal cost (pad slot 0)
    qv: torch.Tensor  # (B, N+1, 5) linear cost (pad slot 0)
    lw: torch.Tensor  # (B, N+1, 5) lower bounds (pad slot -inf)
    uw: torch.Tensor  # (B, N+1, 5) upper bounds (pad slot +inf)

    @property
    def N(self) -> int:
        return self.AB.shape[1]


@dataclasses.dataclass
class SolverCarry:
    """Complete ADMM iterate per lane, persisted across control steps as
    the next solve's warm start."""

    X: torch.Tensor  # (B, N+1, 3)
    U: torch.Tensor  # (B, N, 2)
    Zx: torch.Tensor  # (B, N+1, 3)
    Zu: torch.Tensor  # (B, N, 2)
    Yeq: torch.Tensor  # (B, N+1, 3)
    Yx: torch.Tensor  # (B, N+1, 3)
    Yu: torch.Tensor  # (B, N, 2)
    rho: torch.Tensor  # (B,) adapted step size

    def take(self, idx) -> "SolverCarry":
        """The carries of lanes ``idx``."""
        return _take(self, idx)

    def select(self, keep: torch.Tensor, other: "SolverCarry") -> "SolverCarry":
        """Per lane: this carry where ``keep`` (B,) else ``other``."""
        return SolverCarry(**{
            f.name: _where_lanes(keep, getattr(self, f.name),
                                 getattr(other, f.name))
            for f in dataclasses.fields(self)})


def init_solver_carry(N: int, batch: int, rho0: float = 0.1,
                      device="cuda") -> SolverCarry:
    """A zero warm-start carry for ``batch`` lanes, on the card unless the
    caller names another device."""
    z = lambda *s: torch.zeros((batch,) + s, dtype=torch.float32, device=device)
    return SolverCarry(X=z(N + 1, NX), U=z(N, NU), Zx=z(N + 1, NX),
                       Zu=z(N, NU), Yeq=z(N + 1, NX), Yx=z(N + 1, NX),
                       Yu=z(N, NU),
                       rho=torch.full((batch,), rho0, dtype=torch.float32,
                                      device=device))


class LTVSolution(NamedTuple):
    X: torch.Tensor  # (B, N+1, 3) primal states
    U: torch.Tensor  # (B, N, 2) primal inputs
    status: torch.Tensor  # (B,) int32 — admm.SOLVED / MAX_ITER / DIVERGED
    r_prim: torch.Tensor  # (B,) inf-norm primal residual
    r_dual: torch.Tensor  # (B,) inf-norm dual residual
    carry: SolverCarry  # final iterate for the next step's warm start


def _take(obj, idx):
    return type(obj)(**{f.name: getattr(obj, f.name)[idx]
                        for f in dataclasses.fields(obj)})


def _where_lanes(keep, a, b):
    return torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


# ---------------------------------------------------------------------------
# Layout conversion
# ---------------------------------------------------------------------------

def _pad_u(x_part, u_part, pad_value=0.0):
    """(B, N+1, 3) + (B, N, 2) -> (B, N+1, 5), the stage-N u-slot = pad."""
    pad = torch.full_like(u_part[:, :1], pad_value)
    return torch.cat([x_part, torch.cat([u_part, pad], 1)], -1)


def pack_qp(qp: LTVQP) -> StageQP:
    inf = float("inf")
    return StageQP(AB=torch.cat([qp.A, qp.B], -1), beq=qp.beq,
                   Pd=_pad_u(qp.P_x, qp.P_u), qv=_pad_u(qp.q_x, qp.q_u),
                   lw=_pad_u(qp.lx, qp.lu, -inf), uw=_pad_u(qp.ux, qp.uu, inf))


def pack_carry(c: SolverCarry):
    """Carry -> stage-layout iterate ``(W, Zw, Yeq, Yw)``."""
    return _pad_u(c.X, c.U), _pad_u(c.Zx, c.Zu), c.Yeq, _pad_u(c.Yx, c.Yu)


def unpack_carry(W, Zw, Yeq, Yw, rho) -> SolverCarry:
    return SolverCarry(X=W[..., :NX], U=W[:, :-1, NX:], Zx=Zw[..., :NX],
                       Zu=Zw[:, :-1, NX:], Yeq=Yeq, Yx=Yw[..., :NX],
                       Yu=Yw[:, :-1, NX:], rho=rho)


# ---------------------------------------------------------------------------
# Sequential-order products (the kernel's summation order)
# ---------------------------------------------------------------------------

def _seqsum(p, dim):
    """Sum along ``dim`` strictly left to right."""
    terms = p.unbind(dim)
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _mv(M, v):
    """(..., r, c) @ (..., c) -> (..., r)."""
    return _seqsum(M * v[..., None, :], -1)


def _mtv(M, v):
    """(..., r, c)^T @ (..., r) -> (..., c)."""
    return _seqsum(M * v[..., :, None], -2)


def _mm(A, B):
    """(..., a, b) @ (..., b, c) -> (..., a, c)."""
    return _seqsum(A[..., :, :, None] * B[..., None, :, :], -2)


def _gj_inverse(S):
    """Gauss-Jordan inverse of (..., 5, 5) SPD blocks, no pivoting (the
    Schur complements are positive definite by construction)."""
    n = S.shape[-1]
    a = S
    inv = torch.eye(n, dtype=S.dtype, device=S.device).expand_as(S)
    rows = torch.arange(n, device=S.device)[:, None]
    for k in range(n):
        piv = 1.0 / a[..., k, k]
        ak = a[..., k, :] * piv[..., None]
        ik = inv[..., k, :] * piv[..., None]
        f = a[..., :, k:k + 1]
        is_k = rows == k
        a = torch.where(is_k, ak[..., None, :], a - f * ak[..., None, :])
        inv = torch.where(is_k, ik[..., None, :], inv - f * ik[..., None, :])
    return inv


# ---------------------------------------------------------------------------
# Constraint operators (Aeq is never materialized)
# ---------------------------------------------------------------------------

def eq_apply(sq: StageQP, W):
    """r = Aeq z -> (B, N+1, 3): r_0 = -x_0, r_{n+1} = AB_n w_n - x_{n+1}."""
    rn = _mv(sq.AB, W[:, :-1]) - W[:, 1:, :NX]
    return torch.cat([-W[:, :1, :NX], rn], 1)


def eq_applyT(sq: StageQP, Wq):
    """Aeq' w for w in equality-row space (B, N+1, 3) -> (B, N+1, 5)."""
    g = _mtv(sq.AB, Wq[:, 1:])
    g = torch.cat([g, torch.zeros_like(g[:, :1])], 1)
    return g - torch.cat([Wq, torch.zeros_like(g[..., :NU])], -1)


# ---------------------------------------------------------------------------
# Block-tridiagonal factorization of the reduced KKT matrix
# ---------------------------------------------------------------------------

def _build_blocks(sq: StageQP, rho_eq, rho_w, sigma):
    """Diagonal blocks D (B, N+1, 5, 5) and couplings C (B, N, 3, 5).

    D_n (n < N) = rho_eq (AB_n' AB_n) + diag(Pd_n + sigma + rho_w_n + rho_eq [x rows])
    D_N = diag(Pd_N + sigma + rho_w_N + rho_eq) on x, identity on the pad
    C_n = -rho_eq AB_n: the (stage n+1 x-rows) x (stage n) block
    """
    re = rho_eq[:, None, None, None]
    mask_x = torch.tensor([1.0] * NX + [0.0] * NU, dtype=sq.AB.dtype,
                          device=sq.AB.device)
    diag_base = (sq.Pd + sigma) + rho_w
    AtA = _seqsum(sq.AB[..., :, :, None] * sq.AB[..., :, None, :], -3)
    D_body = AtA * re + torch.diag_embed(
        diag_base[:, :-1] + rho_eq[:, None, None] * mask_x)
    dN = mask_x * (diag_base[:, -1] + rho_eq[:, None]) + (1.0 - mask_x)
    D = torch.cat([D_body, torch.diag_embed(dN)[:, None]], 1)
    return D, -(re * sq.AB)


def _factor(D, C):
    """Schur recursion S_0 = D_0, S_n = D_n - C_{n-1} S_{n-1}^-1 C_{n-1}'
    (x-x block); returns the per-stage inverses Sinv (B, N+1, 5, 5)."""
    Sinv = [_gj_inverse(D[:, 0])]
    for n in range(1, D.shape[1]):
        Cn = C[:, n - 1]
        GCt = _mm(_mm(Cn, Sinv[-1]), Cn.transpose(-1, -2))  # (B, 3, 3)
        S = D[:, n] - torch.nn.functional.pad(GCt, (0, NU, 0, NU))
        Sinv.append(_gj_inverse(S))
    return torch.stack(Sinv, 1)


def _solve(Sinv, C, b):
    """Solve M w = b (b: (B, N+1, 5)) given the Schur factors."""
    N = C.shape[1]
    v = [b[:, 0]]
    for n in range(1, N + 1):
        Gv = _mv(C[:, n - 1], _mv(Sinv[:, n - 1], v[-1]))
        v.append(b[:, n] - torch.nn.functional.pad(Gv, (0, NU)))
    w = [None] * (N + 1)
    w[N] = _mv(Sinv[:, N], v[N])
    for n in range(N - 1, -1, -1):
        w[n] = _mv(Sinv[:, n], v[n] - _mtv(C[:, n], w[n + 1][:, :NX]))
    return torch.stack(w, 1)


# ---------------------------------------------------------------------------
# ADMM on the structured problem
# ---------------------------------------------------------------------------

def admm_iteration(sq: StageQP, solve, rho_eq, rho_w, sigma, alpha, state):
    """One ADMM iteration; ``solve(b)`` solves the factored stage system and
    ``state`` is the stage-layout iterate ``(W, Zw, Yeq, Yw)``."""
    W, Zw, Yeq, Yw = state
    re = rho_eq[:, None, None]
    weq = re * sq.beq - Yeq
    rhs = sigma * W - sq.qv + eq_applyT(sq, weq) + rho_w * Zw - Yw
    Wt = solve(rhs)
    Req = eq_apply(sq, Wt)
    Wn = alpha * Wt + (1.0 - alpha) * W
    # eq rows: the projection pins z to beq; the dual accumulates violation
    Zeq_pre = alpha * Req + (1.0 - alpha) * sq.beq
    Yeq_n = Yeq + re * (Zeq_pre - sq.beq)
    # identity rows: box projection
    Zw_pre = alpha * Wt + (1.0 - alpha) * Zw
    Zw_n = torch.clamp(Zw_pre + Yw / rho_w, sq.lw, sq.uw)
    Yw_n = Yw + rho_w * (Zw_pre - Zw_n)
    return Wn, Zw_n, Yeq_n, Yw_n


def _amax(t):
    """Per-lane inf-norm over every non-batch axis."""
    return t.abs().flatten(1).amax(1)


def primal_residual(sq: StageQP, W):
    """Equality violation and box violation, inf-norm per lane."""
    viol = (sq.lw - W).clamp(min=0.0) + (W - sq.uw).clamp(min=0.0)
    return torch.maximum(_amax(eq_apply(sq, W) - sq.beq),
                         viol.flatten(1).amax(1))


def dual_residual(sq: StageQP, W, Yeq, Yw):
    """``(r_dual, g)``: inf-norm of P z + q + A' y per lane, and A_eq' y."""
    g = eq_applyT(sq, Yeq)
    return _amax(sq.Pd * W + sq.qv + g + Yw), g


def admm_rounds(sq: StageQP, cfg: SolverConfig, state, rho0):
    """The fixed-budget solve from the stage iterate ``state`` with per-lane
    initial step size ``rho0`` (B,): ``cfg.rho_updates`` rounds of
    ``cfg.iterations`` iterations with adaptive rho, then the guarded
    active-set polish.  The stage systems are solved by block cyclic
    reduction under ``cfg.stage_solver == "cr"``, else by the Schur
    recursion.  Returns ``(state, rho)``."""
    # imported here: cyclic_reduction builds on this module's block products
    from multi_purpose_mpc_tpu_torch.ops.cyclic_reduction import (cr_factor,
                                                                  cr_solve)

    sigma, alpha, eq_scale = cfg.sigma, cfg.alpha, cfg.rho_eq_scale
    W, Zw, Yeq, Yw = state
    state = (W, torch.clamp(Zw, sq.lw, sq.uw), Yeq, Yw)
    is_eq = (sq.uw - sq.lw) < 1e-9

    def run_iters(iters, rho, state, boost=None):
        rho_eq = rho * eq_scale
        rs = rho[:, None, None]
        rho_w = torch.where(is_eq, rs * eq_scale, rs)
        if boost is not None:
            rho_w = rho_w * boost
        D, C = _build_blocks(sq, rho_eq, rho_w, sigma)
        if cfg.stage_solver == "cr":
            fac = cr_factor(D, C)
            solve = lambda b: cr_solve(fac, b)
        else:
            Sinv = _factor(D, C)
            solve = lambda b: _solve(Sinv, C, b)
        for _ in range(iters):
            state = admm_iteration(sq, solve, rho_eq, rho_w, sigma, alpha,
                                   state)
        return state

    rho = rho0
    for _ in range(max(cfg.rho_updates, 1)):
        state = run_iters(cfg.iterations, rho, state)
        W, Zw, Yeq, Yw = state
        # adaptive rho from relative residuals
        Req = eq_apply(sq, W)
        rp = torch.maximum(_amax(Req - sq.beq), _amax(W - Zw))
        rd, g = dual_residual(sq, W, Yeq, Yw)
        den_p = torch.maximum(_amax(Req), _amax(W))
        den_d = torch.maximum(
            torch.maximum(_amax(sq.Pd * W), _amax(sq.qv)),
            torch.clamp(_amax(g), min=1e-10))
        ratio = torch.sqrt((rp / den_p.clamp(min=1e-10))
                           / (rd / den_d).clamp(min=1e-12))
        rho_new = torch.clamp(rho * ratio, 1e-6, 1e6)
        rho = torch.where(torch.isfinite(rho_new), rho_new, rho)

    if cfg.polish_iters > 0:
        # Soft active-set polish: boost rho on rows at their finite bounds
        # and run a few more iterations; the candidate is taken per lane
        # only where it lowers the primal residual.
        W, Zw, Yeq, Yw = state
        tol = 1e-4
        at_lo = Zw <= sq.lw + tol
        act = (at_lo | (Zw >= sq.uw - tol)) & torch.isfinite(
            torch.where(at_lo, sq.lw, sq.uw))
        boost = torch.where(act, cfg.polish_boost, 1.0).to(W.dtype)
        polished = run_iters(cfg.polish_iters, rho, state, boost)
        take = primal_residual(sq, polished[0]) < primal_residual(sq, W)
        state = tuple(_where_lanes(take, p, m)
                      for p, m in zip(polished, state))
    return state, rho


def solve_ltv_qp(qp: LTVQP, cfg: SolverConfig,
                 warm: Optional[SolverCarry] = None) -> LTVSolution:
    """Batched ADMM solve of the LTV-MPC QPs (the JAX package's vmapped
    ``solve_ltv_qp``).  ``warm``: the previous step's carry; its adapted rho
    is resumed only under ``cfg.carry_rho``.  Like the JAX package's XLA
    solver it takes the Schur recursion whatever ``cfg.stage_solver`` says
    (the field selects the kernels' stage solver)."""
    cfg = dataclasses.replace(cfg, stage_solver="schur")
    Bsz, N = qp.A.shape[0], qp.N
    dt, dev = qp.A.dtype, qp.A.device
    if warm is None:
        warm = init_solver_carry(N, Bsz, cfg.rho, dev)
    rho0 = (torch.clamp(warm.rho, 1e-6, 1e6) if cfg.carry_rho
            else torch.full((Bsz,), cfg.rho, dtype=dt, device=dev))
    sq = pack_qp(qp)
    (W, Zw, Yeq, Yw), rho = admm_rounds(sq, cfg, pack_carry(warm), rho0)

    r_prim = primal_residual(sq, W)
    r_dual, g = dual_residual(sq, W, Yeq, Yw)
    scale_p = torch.maximum(_amax(eq_apply(sq, W)), _amax(W))
    scale_d = torch.maximum(_amax(sq.qv), _amax(g))
    eps_p = cfg.eps_abs + cfg.eps_rel * scale_p
    eps_d = cfg.eps_abs + cfg.eps_rel * scale_d
    finite = torch.isfinite(W).flatten(1).all(1)
    status = solver_status(finite, (r_prim <= eps_p) & (r_dual <= eps_d))
    # a diverged iterate must not poison the next step's warm start
    carry = unpack_carry(W, Zw, Yeq, Yw, rho).select(
        finite, init_solver_carry(N, Bsz, cfg.rho, dev))
    return LTVSolution(X=W[..., :NX], U=W[:, :-1, NX:], status=status,
                       r_prim=r_prim, r_dual=r_dual, carry=carry)


def solver_status(finite, converged):
    """SOLVED / MAX_ITER / DIVERGED per lane."""
    return torch.where(~finite, admm_mod.DIVERGED,
                       torch.where(converged, admm_mod.SOLVED,
                                   admm_mod.MAX_ITER)).to(torch.int32)
