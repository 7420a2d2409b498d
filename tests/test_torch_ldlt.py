"""The Schur stage solve as a block LDL' solve (ops/ltv_qp.py ``_factor``,
``_solve``; the plain version of kernels K1 and K3's stage solve), on the
CPU.

The reduced KKT matrix M is block tridiagonal: diagonal blocks D_n and
couplings C_n (3x5, into stage n + 1's x-rows).  ``_factor`` returns the
Schur inverses Sinv_n and G_n = C_n Sinv_n, so M = L diag(S) L' with L's
sub-diagonal blocks pad(G_n); ``_solve`` runs L y = b, z = Sinv y, L' w = z.
The systems are random, built by ``_build_blocks`` at the equality step
sizes rho_eq = 1e-1, 1e3 and 1e6 (the range the LiDAR fleet's carried rho
reaches), and each solve is held against a float64 dense solve of M.

The bars are twice the relative errors of the solve the LDL' form
replaced, w_n = Sinv_n (v_n - C_n' w_{n+1}[x]) after v_{n+1} = b_{n+1} -
pad(C_n (Sinv_n v_n)), measured on these very systems (seed 0, 256 lanes,
N = 30): per lane max |w - x| / max |x|, the largest and the median lane.
"""

import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu_torch.ops.ltv_qp import (NW, NX, StageQP, _build_blocks,
                                                    _factor, _gj_inverse, _mm,
                                                    _solve)

B, N = 256, 30

# rho_eq -> (largest lane, median lane) of the replaced solve's error
REPLACED = {
    1e-1: (3.0496e-07, 1.0047e-07),
    1e3: (1.7499e-02, 2.3104e-03),
    1e6: (6.9266e-04, 2.3116e-05),
}


def _system(rho_eq, seed=0):
    """Blocks D, C and a right-hand side b: random stages, rho_w =
    rho_eq / 1e3 (the step size of the inequality rows), sigma 1e-6."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    sq = StageQP(AB=t(rng.uniform(-1, 1, (B, N, 3, 5))),
                 beq=t(rng.normal(size=(B, N + 1, 3))),
                 Pd=t(rng.uniform(0.1, 2.0, (B, N + 1, 5))),
                 qv=t(rng.normal(size=(B, N + 1, 5))),
                 lw=t(-np.ones((B, N + 1, 5))), uw=t(np.ones((B, N + 1, 5))))
    re = torch.full((B,), rho_eq, dtype=torch.float32)
    rho_w = (re / 1e3)[:, None, None].expand(B, N + 1, NW).contiguous()
    D, C = _build_blocks(sq, re, rho_w, 1e-6)
    return D, C, t(rng.normal(size=(B, N + 1, NW)))


def _dense(D, C):
    """M as a dense (B, 5S, 5S) float64 array."""
    S = D.shape[1]
    M = np.zeros((D.shape[0], S * NW, S * NW))
    for n in range(S):
        M[:, n * NW:(n + 1) * NW, n * NW:(n + 1) * NW] = D[:, n]
        if n < S - 1:
            rows = slice((n + 1) * NW, (n + 1) * NW + NX)
            M[:, rows, n * NW:(n + 1) * NW] = C[:, n]
            M[:, n * NW:(n + 1) * NW, rows] = np.swapaxes(C[:, n], -1, -2)
    return M


@pytest.mark.parametrize("rho_eq", sorted(REPLACED))
def test_ldlt_solve_against_float64(rho_eq):
    D, C, b = _system(rho_eq)
    Sinv, G = _factor(D, C)
    w = _solve(Sinv, G, b)
    assert w.shape == b.shape and w.dtype == torch.float32
    x = np.linalg.solve(_dense(D.double().numpy(), C.double().numpy()),
                        b.double().numpy().reshape(B, -1, 1)).reshape(b.shape)
    err = (np.abs(w.double().numpy() - x).max(axis=(1, 2))
           / np.abs(x).max(axis=(1, 2)))
    largest, median = REPLACED[rho_eq]
    assert err.max() <= 2 * largest, (err.max(), largest)
    assert np.median(err) <= 2 * median, (np.median(err), median)


def test_factor_g_is_c_sinv_bitwise():
    """G_n is C_n Sinv_n as the recursion forms it, bit for bit, and Sinv_n
    the inverse of S_n = D_n - G_{n-1} C_{n-1}' (x-x block)."""
    D, C, _ = _system(1e3)
    Sinv, G = _factor(D, C)
    assert Sinv.shape == (B, N + 1, NW, NW) and G.shape == (B, N, NX, NW)
    assert torch.equal(Sinv[:, 0], _gj_inverse(D[:, 0]))
    for n in range(N):
        assert torch.equal(G[:, n], _mm(C[:, n], Sinv[:, n]))
        GCt = _mm(G[:, n], C[:, n].transpose(-1, -2))
        S = D[:, n + 1] - torch.nn.functional.pad(GCt, (0, NW - NX,
                                                        0, NW - NX))
        assert torch.equal(Sinv[:, n + 1], _gj_inverse(S))
