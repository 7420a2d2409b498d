"""Spatial kinematic bicycle model (port of ``models/bicycle.py``).

* temporal (world) state: pose ``(x, y, psi)``;
* spatial state relative to a path waypoint: ``(e_y, e_psi, t)``;
* plant input ``u = (v, delta)``; QP input ``(v, kappa)`` with
  ``delta = atan(kappa L)``.

Every function works on a fleet: the leading axis B of each tensor is the
JAX package's ``vmap`` axis written out.
"""

from __future__ import annotations

import dataclasses

import torch

from multi_purpose_mpc_tpu_torch.ops.ltv_qp import SolverCarry, init_solver_carry
from multi_purpose_mpc_tpu_torch.ops.path import PathData, gather_waypoint_index, wrap_angle


@dataclasses.dataclass
class CarState:
    """Complete per-lane closed-loop state, leading fleet axis B."""

    x: torch.Tensor  # (B,) world pose
    y: torch.Tensor
    psi: torch.Tensor
    s: torch.Tensor  # (B,) progress along the path
    wp_id: torch.Tensor  # (B,) int32
    e_y: torch.Tensor  # (B,) spatial state at the current waypoint
    e_psi: torch.Tensor
    u_seq: torch.Tensor  # (B, 2N) cached control sequence for replay
    solver: SolverCarry  # persistent ADMM iterate (warm start)
    infeasibility_count: torch.Tensor  # (B,) int32 consecutive failures
    done: torch.Tensor  # (B,) bool: reached the end of the path
    failed: torch.Tensor  # (B,) bool: N-1 consecutive infeasible solves

    @property
    def batch(self) -> int:
        return self.x.shape[0]


def init_car_state(path: PathData, N: int, e_y=0.0, e_psi=0.0,
                   wp_id=0) -> CarState:
    """Initial states on the path; ``e_y``/``e_psi``/``wp_id`` are scalars
    (one lane) or (B,) per-lane values.  The replay cache is seeded with the
    local speed profile, as in the JAX package."""
    dev = path.x.device
    f32 = torch.float32
    wp = torch.as_tensor(wp_id, dtype=torch.int32, device=dev).reshape(-1)
    e_y = torch.as_tensor(e_y, dtype=f32, device=dev).reshape(-1)
    e_psi = torch.as_tensor(e_psi, dtype=f32, device=dev).reshape(-1)
    B = max(wp.shape[0], e_y.shape[0], e_psi.shape[0])
    wp, e_y, e_psi = wp.expand(B), e_y.expand(B), e_psi.expand(B)
    wpl = wp.long()
    psi_w = path.psi[wpl]
    u_seed = torch.zeros((B, N, 2), dtype=f32, device=dev)
    u_seed[:, :, 0] = path.v_ref[horizon_indices(path, wp, N)]
    return CarState(
        x=path.x[wpl] - e_y * torch.sin(psi_w),
        y=path.y[wpl] + e_y * torch.cos(psi_w),
        psi=psi_w + e_psi,
        s=path.cum_len[wpl].clone(),
        wp_id=wp.clone(),
        e_y=e_y.clone(),
        e_psi=e_psi.clone(),
        u_seq=u_seed.reshape(B, 2 * N),
        solver=init_solver_carry(N, B, device=dev),
        infeasibility_count=torch.zeros(B, dtype=torch.int32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        failed=torch.zeros(B, dtype=torch.bool, device=dev),
    )


def s2t(path: PathData, wp_id, e_y, e_psi):
    """Spatial -> temporal: world pose from path-relative error state."""
    wp = wp_id.long()
    wpsi = path.psi[wp]
    x = path.x[wp] - e_y * torch.sin(wpsi)
    y = path.y[wp] + e_y * torch.cos(wpsi)
    return x, y, wpsi + e_psi


def t2s(path: PathData, wp_id, x, y, psi):
    """Temporal -> spatial: ``(e_y, e_psi)`` with e_psi wrapped."""
    wp = wp_id.long()
    wx, wy, wpsi = path.x[wp], path.y[wp], path.psi[wp]
    e_y = torch.cos(wpsi) * (y - wy) - torch.sin(wpsi) * (x - wx)
    return e_y, wrap_angle(psi - wpsi)


def locate_waypoint(path: PathData, s):
    """Nearest waypoint by traveled distance: the closer of the two
    waypoints enclosing ``s`` in the cumulative lengths (clamped; circular
    paths wrap)."""
    n = path.n_wp
    if path.circular:
        s = torch.remainder(s, path.length)
    next_id = torch.searchsorted(path.cum_len, s, right=True)
    next_id = torch.clamp(next_id, 1, n - 1)
    prev_id = next_id - 1
    d_next = (s - path.cum_len[next_id]).abs()
    d_prev = (s - path.cum_len[prev_id]).abs()
    return torch.where(d_next < d_prev, next_id, prev_id).to(torch.int32)


def drive(state: CarState, path: PathData, v, delta, length: float,
          Ts: float) -> CarState:
    """One forward-Euler step of the nonlinear kinematic bicycle; progress
    integrates sdot = v cos(e_psi) / (1 - e_y kappa) at the current
    waypoint."""
    x = state.x + v * torch.cos(state.psi) * Ts
    y = state.y + v * torch.sin(state.psi) * Ts
    psi = state.psi + v / length * torch.tan(delta) * Ts
    kappa = path.kappa[state.wp_id.long()]
    s_dot = v * torch.cos(state.e_psi) / (1.0 - state.e_y * kappa)
    s = state.s + s_dot * Ts
    return dataclasses.replace(state, x=x, y=y, psi=psi, s=s)


def spatial_derivatives(e_y, e_psi, v, delta, kappa, length: float):
    """Spatial-domain derivatives d(e_y, e_psi, t)/ds, stacked on the last
    axis (reference: spatial_bicycle_models.py:368-389)."""
    s_dot = v * torch.cos(e_psi) / (1.0 - e_y * kappa)
    psi_dot = v / length * torch.tan(delta)
    return torch.stack([v * torch.sin(e_psi) / s_dot,
                        psi_dot / s_dot - kappa,
                        1.0 / s_dot], -1)


def linearize(v_ref, kappa_ref, delta_s):
    """Exact LTV triple (f, A, B) of the spatial model around the reference,
    over any leading shape::

        A = [[1, ds, 0], [-k^2 ds, 1, 0], [-k/v ds, 0, 1]]
        B = [[0, 0], [0, ds], [-ds/v^2, 0]]
        f = [0, 0, ds/v]
    """
    z = torch.zeros_like(v_ref)
    o = torch.ones_like(v_ref)
    A = torch.stack([
        torch.stack([o, delta_s, z], -1),
        torch.stack([-(kappa_ref ** 2) * delta_s, o, z], -1),
        torch.stack([-kappa_ref / v_ref * delta_s, z, o], -1),
    ], -2)
    B = torch.stack([
        torch.stack([z, z], -1),
        torch.stack([z, delta_s], -1),
        torch.stack([-delta_s / (v_ref ** 2), z], -1),
    ], -2)
    f = torch.stack([z, z, delta_s / v_ref], -1)
    return f, A, B


def horizon_indices(path: PathData, wp_id, N: int):
    """(B, N) waypoint indices ``wp_id + n`` with wrap/clamp."""
    offs = torch.arange(N, device=wp_id.device)
    return gather_waypoint_index(path, wp_id.long()[:, None], offs[None, :])
