"""Curvature-limited speed profile QP (port of ``ops/speed_profile.py``).

    minimize   sum_i ( 1/2 v_i^2 - v_max_dyn,i * v_i )
    subject to a_min <= (v_{i+1} - v_i) / (2 l_i) <= a_max      (i < N-1)
               v_min <= v_i <= min(v_max, sqrt(ay_max / |kappa_i|))

over the N = n_wp - 1 non-terminal waypoints, solved once per path by the
dense ADMM; the last waypoint copies its neighbour's speed.  Without it
``v_ref == 0`` and every control QP is NaN.
"""

from __future__ import annotations

import dataclasses

import torch

from multi_purpose_mpc_tpu_torch.config import SolverConfig, SpeedProfileConstraints
from multi_purpose_mpc_tpu_torch.ops.admm import admm_solve
from multi_purpose_mpc_tpu_torch.ops.path import PathData

_EPS = 1e-12


def compute_speed_profile(path: PathData, c: SpeedProfileConstraints,
                          solver: SolverConfig | None = None) -> PathData:
    """Returns a new PathData with ``v_ref`` filled in."""
    N = path.n_wp - 1
    dt, dev = path.x.dtype, path.x.device
    kappa = path.kappa[:N]
    li = path.seg_dist[:N]
    v_max_dyn = torch.clamp(torch.sqrt(c.ay_max / (kappa.abs() + _EPS)),
                            max=c.v_max)

    rows = torch.arange(N - 1, device=dev)
    D1 = torch.zeros((N - 1, N), dtype=dt, device=dev)
    D1[rows, rows] = -1.0 / (2.0 * li[:-1])
    D1[rows, rows + 1] = 1.0 / (2.0 * li[:-1])
    A = torch.cat([D1, torch.eye(N, dtype=dt, device=dev)])
    l = torch.cat([torch.full((N - 1,), c.a_min, dtype=dt, device=dev),
                   torch.full((N,), c.v_min, dtype=dt, device=dev)])
    u = torch.cat([torch.full((N - 1,), c.a_max, dtype=dt, device=dev),
                   v_max_dyn])
    P = torch.eye(N, dtype=dt, device=dev)

    res = admm_solve(P, -v_max_dyn, A, l, u,
                     solver or SolverConfig(iterations=100, rho_updates=8))
    return dataclasses.replace(path, v_ref=torch.cat([res.x, res.x[-1:]]))
