"""Convex QPs solved to convergence in float64 by a primal-dual interior
point method: min 1/2 z'Pz + q'z  s.t.  Aeq z = beq,  lo <= z <= hi (a
bound may be infinite).  Each iteration is one dense solve of the KKT
system with the bounds' barrier terms on its diagonal; Mehrotra-free
path following with a fixed centring of 0.1 and fraction-to-boundary
steps of 0.995.  A QP with no strictly feasible point (a pinched corridor)
makes no progress; ``converged`` says which QPs met the tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = 1e-9


def solve(P, q, Aeq, beq, lo, hi, iters: int = 60):
    """Batched over a leading axis L: P (L, n, n), q (L, n), Aeq (L, m, n),
    beq (L, m), lo/hi (L, n).  Returns ``(z (L, n), converged (L,))``."""
    L, n = q.shape
    m = beq.shape[1]
    dt, dev = q.dtype, q.device
    has_l, has_u = torch.isfinite(lo), torch.isfinite(hi)
    lo0 = torch.where(has_l, lo, torch.zeros_like(lo))
    hi0 = torch.where(has_u, hi, torch.zeros_like(hi))
    z = torch.where(has_l & has_u, 0.5 * (lo0 + hi0),
                    torch.where(has_l, lo0 + 1.0,
                                torch.where(has_u, hi0 - 1.0,
                                            torch.zeros_like(lo0))))
    y = torch.zeros((L, m), dtype=dt, device=dev)
    one = torch.ones_like(z)
    sl = torch.where(has_l, torch.clamp(z - lo0, min=1.0), one)
    su = torch.where(has_u, torch.clamp(hi0 - z, min=1.0), one)
    zl = has_l.to(dt)
    zu = has_u.to(dt)
    nc = (has_l.sum(1) + has_u.sum(1)).clamp(min=1).to(dt)
    AeqT = Aeq.transpose(1, 2)
    K = torch.zeros((L, n + m, n + m), dtype=dt, device=dev)
    K[:, n:, :n] = Aeq
    K[:, :n, n:] = AeqT
    eye = 1e-12 * torch.eye(n + m, dtype=dt, device=dev)
    mv = lambda M, v: (M @ v[..., None])[..., 0]

    def residuals():
        rd = mv(P, z) + q + mv(AeqT, y) - zl * has_l + zu * has_u
        rpe = mv(Aeq, z) - beq
        rl = torch.where(has_l, z - lo0 - sl, torch.zeros_like(z))
        ru = torch.where(has_u, hi0 - z - su, torch.zeros_like(z))
        mu = ((sl * zl * has_l).sum(1) + (su * zu * has_u).sum(1)) / nc
        return rd, rpe, rl, ru, mu

    def step_to_boundary(v, dv, mask):
        ratio = torch.where(mask & (dv < 0), -v / dv.clamp(max=-1e-300),
                            torch.full_like(v, np.inf))
        return torch.clamp(0.995 * ratio.amin(1), max=1.0)

    for _ in range(iters):
        rd, rpe, rl, ru, mu = residuals()
        mu_t = 0.1 * mu[:, None]
        dl = torch.where(has_l, zl / sl, torch.zeros_like(z))
        du = torch.where(has_u, zu / su, torch.zeros_like(z))
        gl = torch.where(has_l, mu_t / sl - dl * rl, torch.zeros_like(z))
        gu = torch.where(has_u, mu_t / su - du * ru, torch.zeros_like(z))
        Kt = K.clone()
        Kt[:, :n, :n] = P + torch.diag_embed(dl + du)
        rhs = torch.cat([-(mv(P, z) + q + mv(AeqT, y)) + gl - gu, -rpe], 1)
        sol = torch.linalg.solve(Kt + eye, rhs)
        dz, dy = sol[:, :n], sol[:, n:]
        dsl = torch.where(has_l, rl + dz, torch.zeros_like(z))
        dsu = torch.where(has_u, ru - dz, torch.zeros_like(z))
        dzl = torch.where(has_l, (mu_t - zl * dsl) / sl - zl, torch.zeros_like(z))
        dzu = torch.where(has_u, (mu_t - zu * dsu) / su - zu, torch.zeros_like(z))
        a = torch.minimum(
            torch.minimum(step_to_boundary(sl, dsl, has_l),
                          step_to_boundary(su, dsu, has_u)),
            torch.minimum(step_to_boundary(zl, dzl, has_l),
                          step_to_boundary(zu, dzu, has_u)))[:, None]
        z = z + a * dz
        y = y + a * dy
        sl = torch.where(has_l, sl + a * dsl, sl)
        su = torch.where(has_u, su + a * dsu, su)
        zl = torch.where(has_l, zl + a * dzl, zl)
        zu = torch.where(has_u, zu + a * dzu, zu)
    rd, rpe, rl, ru, mu = residuals()
    worst = torch.stack([rd.abs().amax(1), rpe.abs().amax(1),
                         rl.abs().amax(1), ru.abs().amax(1), mu], 1).amax(1)
    return z, worst < TOL


def solve_dense(P, q, A, l, u, lo, hi):
    """One QP with general inequality rows l <= A z <= u besides the bounds
    (numpy float64): the rows become slack variables s = A z with bounds.
    Raises unless it converges."""
    n, m = q.shape[0], A.shape[0]
    Pf = np.zeros((n + m, n + m))
    Pf[:n, :n] = P
    qf = np.concatenate([q, np.zeros(m)])
    Aeq = np.concatenate([A, -np.eye(m)], 1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))[None]
    z, ok = solve(t(Pf), t(qf), t(Aeq), t(np.zeros(m)),
                  t(np.concatenate([lo, l])), t(np.concatenate([hi, u])))
    if not bool(ok[0]):
        raise RuntimeError("the speed-profile QP did not converge")
    return z[0, :n].numpy()
