"""Block cyclic reduction (CR) of the ADMM stage system: the plain version
of the ``stage_solver="cr"`` branch of kernels K1 and K3.

Port of ``factor_cr`` / ``solve_cr`` and their plane-matrix helpers in the
JAX package's ``ops/admm_pallas.py`` (``_make_kernel``).  The system is the
one the Schur recursion of :mod:`.ltv_qp` solves: block tridiagonal over
the N + 1 stages, with 5x5 diagonal blocks ``D`` and couplings
``O_s = M[s, s-1]`` whose u-rows are structural zeros (``O_s = C_{s-1}``,
the (3, 5) blocks of ``ltv_qp._build_blocks``).

The stages are padded to ``mfull = 2^k - 1 >= N + 1`` with decoupled
identity stages (zero coupling, zero right-hand side).  Each level splits
its ``mc`` stages into the ``e = (mc + 1) / 2`` even ones, which it
eliminates, and the ``mp = (mc - 1) / 2`` odd ones, which form the next
level; the last level's one stage is inverted directly.  A solve is then
log2(mfull + 1) levels down and as many up, each parallel over its stages,
instead of the Schur recursion's 2 x N dependent stage steps.

Every product sums its terms left to right in the JAX package's order and
skips the structural zeros it skips (the u-rows of the couplings), and the
5x5 inverses are the Gauss-Jordan of :func:`.ltv_qp._gj_inverse`: the CUDA
kernels (``csrc/admm_core.cuh``, ``cr_factor`` / ``cr_solve``) repeat this
arithmetic operation for operation and agree with it bit for bit.  The
blocks come from ``ltv_qp._build_blocks``, whose x-row diagonal sums as the
JAX package's Schur kernel sums it, rho_eq AtA + (diag + rho_eq), where its
CR kernel sums (rho_eq AtA + diag) + rho_eq: one rounding apart, which
moves the unconverged pinch-point lane of tests/test_torch_cr.py as one
ulp on one input does (``tools/cr_lane.py``).  Every tensor carries a
leading fleet axis B.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from multi_purpose_mpc_tpu_torch.ops.ltv_qp import (NU, NW, NX, _gj_inverse,
                                                    _mm, _mtv, _mv)


def padded_stages(S: int) -> int:
    """``mfull``: the least 2^k - 1 >= ``S`` (the JAX package's
    ``mfull_cr``): 31 stages fit exactly, 32 pad to 63."""
    m = 1
    while m < S + 1:
        m *= 2
    return m - 1


class CRLevel(NamedTuple):
    """One reduction level: the inverted even-stage blocks and the
    couplings of the odd stages to their left and right even neighbours."""

    Dinv: torch.Tensor  # (B, e, 5, 5) inverses of the even stages' blocks
    OL: torch.Tensor  # (B, mp, 3, 5) O_{2t+1}: odd stage 2t+1 to even 2t
    OR: torch.Tensor  # (B, mp, 3, 5) O_{2t+2}: even stage 2t+2 to odd 2t+1


class CRFactor(NamedTuple):
    levels: List[CRLevel]
    Dinv_f: torch.Tensor  # (B, 1, 5, 5) the last level's one inverse


def cr_factor(D, C) -> CRFactor:
    """Factor the stage system of diagonal blocks ``D`` (B, N+1, 5, 5) and
    couplings ``C`` (B, N, 3, 5).  Per level:

        D'_t = (Do_t - OL_t Dinv_t OL_t') - OR_t' Dinv_{t+1} OR_t
        O'_t = -(OL_t Dinv_t OR_{t-1})          (t >= 1; O'_0 = 0)
    """
    Bsz, S = D.shape[:2]
    mfull = padded_stages(S)
    eye = torch.eye(NW, dtype=D.dtype, device=D.device)
    D = torch.cat([D, eye.expand(Bsz, mfull - S, NW, NW)], 1)
    zero = C.new_zeros((Bsz, 1, NX, NW))
    O = torch.cat([zero, C, C.new_zeros((Bsz, mfull - S, NX, NW))], 1)
    levels = []
    mc = mfull
    while mc > 1:
        mp = (mc - 1) // 2
        Dinv = _gj_inverse(D[:, 0::2])
        OL, OR = O[:, 1::2], O[:, 2::2]
        # (OL Dinv OL') on the x-x block, (OR' Dinv OR) on the whole block;
        # only the x-rows of Dinv OR meet OR' (its u-columns are zero)
        t1 = _mm(OL, _mm(Dinv[:, :mp], OL.transpose(-1, -2)))
        t2 = _mm(OR.transpose(-1, -2), _mm(Dinv[:, 1:, :NX, :NX], OR))
        D_next = (D[:, 1::2] - F.pad(t1, (0, NU, 0, NU))) - t2
        Ob = -_mm(OL[:, 1:], _mm(Dinv[:, 1:mp, :, :NX], OR[:, :mp - 1]))
        levels.append(CRLevel(Dinv, OL, OR))
        D, O = D_next, torch.cat([zero, Ob], 1)
        mc = mp
    return CRFactor(levels, _gj_inverse(D))


def cr_solve(fac: CRFactor, b):
    """Solve the factored stage system for ``b`` (B, N+1, 5): down through
    the levels (the even stages' solves folded into the odd stages'
    right-hand sides), the last stage, then up (the even stages from their
    solved odd neighbours)."""
    Bsz, S = b.shape[:2]
    mfull = 2 * fac.levels[0].Dinv.shape[1] - 1
    bp = torch.cat([b, b.new_zeros((Bsz, mfull - S, NW))], 1)
    evens = []
    for lv in fac.levels:
        mp = lv.OL.shape[1]
        be = bp[:, 0::2]
        u = _mv(lv.Dinv, be)
        t1 = _mv(lv.OL, u[:, :mp])
        t2 = _mtv(lv.OR, u[:, 1:, :NX])
        bp = (bp[:, 1::2] - F.pad(t1, (0, NU))) - t2
        evens.append(be)
    w = _mv(fac.Dinv_f, bp)
    for lv, be in zip(reversed(fac.levels), reversed(evens)):
        mp = lv.OL.shape[1]
        prod = _mv(lv.OR, w)  # from the odd neighbour on the left
        right = _mtv(lv.OL, w[..., :NX])  # from the odd neighbour on the right
        rhs = ((be - F.pad(prod, (0, NU, 1, 0)))
               - F.pad(right, (0, 0, 0, 1)))
        we = _mv(lv.Dinv, rhs)
        w = torch.cat([torch.stack([we[:, :mp], w], 2).flatten(1, 2),
                       we[:, mp:]], 1)
    return w[:, :S]
