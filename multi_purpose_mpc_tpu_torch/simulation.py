"""Closed-loop rollouts (port of ``multi_purpose_mpc_tpu/simulation.py``).

The JAX package's ``lax.scan`` over time becomes a Python loop of fleet
steps; per-step logs are stacked into (T, B) tensors on the fleet's device.
Only the static-grid rollout is ported: free segments and the windowed
horizon table are built once per rollout, and every step goes through the
table, kernel K2 and kernel K1.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.config import MPCConfig, ModelConfig, SimConfig
from multi_purpose_mpc_tpu_torch.models.bicycle import (
    CarState, drive, horizon_indices, init_car_state)
from multi_purpose_mpc_tpu_torch.mpc import (
    ControlOutput, corridor_violation_floor, mpc_corridor, mpc_step_batched)
from multi_purpose_mpc_tpu_torch.ops.constraints import extract_all_segments
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap
from multi_purpose_mpc_tpu_torch.ops.horizon_table import build_horizon_table
from multi_purpose_mpc_tpu_torch.ops.path import PathData


class SimLog(NamedTuple):
    """Per-step logs, (T, B) each (time-major, like the JAX package)."""

    x: torch.Tensor
    y: torch.Tensor
    psi: torch.Tensor
    v: torch.Tensor
    delta: torch.Tensor
    s: torch.Tensor
    e_y: torch.Tensor
    status: torch.Tensor  # raw solver status (SOLVED/MAX_ITER/DIVERGED)
    ok: torch.Tensor  # control accepted (reference-semantics acceptance)
    r_prim: torch.Tensor  # QP primal residual
    floor: torch.Tensor  # certified violation floor (> 0: QP infeasible)
    active: torch.Tensor


class SimResult(NamedTuple):
    final_state: CarState
    log: SimLog


def _post_control(out: ControlOutput, path: PathData, model: ModelConfig):
    """Plant step + one step of logs after a fleet control step."""
    st = out.state
    active = ~(st.done | st.failed)
    v = torch.where(active, out.v, torch.zeros_like(out.v))
    delta = torch.where(active, out.delta, torch.zeros_like(out.delta))
    st = drive(st, path, v, delta, model.length, model.Ts)
    # end of lap: the reference's loop condition (simulation.py:134)
    st = dataclasses.replace(st, done=st.done | (st.s >= path.length))
    log = SimLog(x=st.x, y=st.y, psi=st.psi, v=v, delta=delta, s=st.s,
                 e_y=st.e_y, status=out.status, ok=out.ok, r_prim=out.r_prim,
                 floor=out.floor, active=active)
    return st, log


def static_horizon_table(grid: GridMap, path: PathData, cfg: MPCConfig,
                         model: ModelConfig) -> torch.Tensor:
    """Free segments at every waypoint + the windowed horizon table: the
    once-per-rollout setup of the static-grid path."""
    segs = extract_all_segments(grid, path, 2.0 * model.safety_margin,
                                n_samples=cfg.n_scan_samples,
                                max_segments=cfg.max_segments)
    return build_horizon_table(path, segs, cfg)


def simulate_fleet(grid: GridMap, path: PathData, cfg: MPCConfig,
                   model: ModelConfig, sim: SimConfig, state0: CarState,
                   table: Optional[torch.Tensor] = None) -> SimResult:
    """Fleet closed-loop rollout of ``sim.max_steps`` steps; ``state0``
    carries a leading batch axis.  ``table``: a prebuilt horizon table
    (:func:`static_horizon_table`), built here when omitted."""
    if not sim.static_grid:
        raise NotImplementedError("only the static-grid rollout is ported")
    if table is None:
        table = static_horizon_table(grid, path, cfg, model)
    state, logs = state0, []
    for _ in range(sim.max_steps):
        out = mpc_step_batched(state, path, cfg, model, table)
        state, log = _post_control(out, path, model)
        logs.append(log)
    return SimResult(final_state=state,
                     log=SimLog(*(torch.stack(f) for f in zip(*logs))))


def simulate_closed_loop(grid: GridMap, path: PathData, cfg: MPCConfig,
                         model: ModelConfig, sim: SimConfig,
                         state0: Optional[CarState] = None,
                         table: Optional[torch.Tensor] = None) -> SimResult:
    """Single-car rollout: the fleet path at batch 1 (the kernels included).
    Logs come back as (T,); ``final_state`` keeps its batch axis of 1."""
    if state0 is None:
        state0 = init_car_state(path, cfg.N)
    if state0.batch != 1:
        raise ValueError(f"simulate_closed_loop takes one car, got {state0.batch}")
    res = simulate_fleet(grid, path, cfg, model, sim, state0, table=table)
    return SimResult(final_state=res.final_state,
                     log=SimLog(*(f[:, 0] for f in res.log)))


def init_fleet(path: PathData, N: int, batch: int, e_y0=None, e_psi0=None,
               wp_id0=None) -> CarState:
    """Batch of initial states, optionally perturbed per lane."""
    dev = path.x.device
    zeros = torch.zeros(batch, dtype=torch.float32, device=dev)
    return init_car_state(
        path, N, zeros if e_y0 is None else e_y0,
        zeros if e_psi0 is None else e_psi0,
        torch.zeros(batch, dtype=torch.int32, device=dev)
        if wp_id0 is None else wp_id0)


def feasible_starts(grid: GridMap, path: PathData, cfg: MPCConfig,
                    model: ModelConfig, batch: int, rng: np.random.Generator,
                    e_y_scale: float = 0.03, margin: float = 2e-3,
                    max_rounds: int = 8):
    """Draw ``batch`` Monte-Carlo starts (wp_id0, e_y0) whose first QP is
    certified feasible: clip each e_y into the start corridor, resample
    lanes whose violation floor is still positive.  Draws from ``rng`` in
    the same order as the JAX package, so one seed gives both packages the
    same starts.  Returns (wp_id0 (B,) int32, e_y0 (B,) float32)."""
    dev = path.x.device
    segs = extract_all_segments(grid, path, 2.0 * model.safety_margin,
                                n_samples=cfg.n_scan_samples,
                                max_segments=cfg.max_segments)

    def check(wp, ey):
        w = torch.as_tensor(wp, dtype=torch.int32, device=dev)
        e = torch.as_tensor(np.asarray(ey, np.float32), device=dev)
        cor = mpc_corridor(w, path, cfg, model, segs)
        lo = cor.lb[:, 0] + margin
        hi = cor.ub[:, 0] - margin
        e = torch.minimum(torch.maximum(e, torch.minimum(lo, hi)), hi)
        idx = horizon_indices(path, w, cfg.N)
        horizon = (path.v_ref[idx], path.kappa[idx], path.seg_dist[idx])
        fl = corridor_violation_floor(e, torch.zeros_like(e), horizon, cor,
                                      cfg, model)
        return e.cpu().numpy(), fl.cpu().numpy()

    wp = rng.integers(0, path.n_wp, batch)
    ey = rng.uniform(-e_y_scale, e_y_scale, batch)
    for _ in range(max_rounds):
        ey, fl = check(wp, ey)
        bad = fl > 0
        if not bad.any():
            break
        wp[bad] = rng.integers(0, path.n_wp, int(bad.sum()))
        ey[bad] = rng.uniform(-e_y_scale, e_y_scale, int(bad.sum()))
    else:
        # pathological leftovers: the start waypoint (always feasible)
        ey, fl = check(wp, ey)
        bad = fl > 0
        wp[bad] = 0
        ey[bad] = 0.0
    return (torch.as_tensor(wp, dtype=torch.int32, device=dev),
            torch.as_tensor(ey, dtype=torch.float32, device=dev))
