"""Port parity, the slice end to end: the port's static-grid fleet step
(horizon table -> K2 twin -> K1 twin -> accept/replay -> plant) against the
JAX package's CPU fleet step (its XLA branch), B = 8 lanes from
feasible_starts, 10 steps.

Protocol (tests/test_parity.py's): each port step starts from the JAX
run's exact pre-step state — pose, progress, replay cache, counters and
solver carry — so the two controller+plant steps are compared at every
state the reference visits.  The carried step size is reset to cfg.rho
on both sides (the JAX solver's default, carry_rho=False; the fused solve
resumes whatever rho its carry holds).

What the bars can pin (measured on this scenario, seeds 3-8, production
budget 30 x 6 + 10): both packages run the same fixed-budget float32 ADMM
in a different operation order.  e_y (before the solve) agrees to 1e-8.
Wherever both accept, x', y', s' hold 1e-3 on >= 98.6 % of lane-steps and
the median lane-step agrees to ~1e-6; the exceptions are unconverged
pinch-point solves, where op order alone moves the speed command by up to
3.8e-2 (x', y', s' by up to 2.1e-3) and the heading by up to 1.2e-2.
Cranking the budget to tests/test_parity.py's 200 x 10 + 40 closes it only
where no lane meets a pinch point: seed 3 then holds 1e-3 on x', y', s',
v and e_y on every lane-step (psi' 2.3e-3), seed 6 still differs by 3.7e-2
in v on an accepted step (and that budget costs ~75 s on the CPU).  So the
literal "1e-3 on every lane-step" cannot hold between two float32 solvers.
The bars therefore pin the typical step tightly and the tail to the
behavioural bands of tests/test_parity.py (psi' 5e-2) and bench.py's
pinch-point band, widened to cover the measured tail (v 1e-1).
Acceptance may differ only where both residuals straddle feas_tol within a
factor 2 (measured agreement >= 98.75 %).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.simulation import (_sim_step_batched,
                                              feasible_starts as jfeasible,
                                              init_fleet as jinit_fleet)

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import SimConfig
from multi_purpose_mpc_tpu_torch.mpc import mpc_step_batched
from multi_purpose_mpc_tpu_torch.ops.horizon_table import build_horizon_table
from tests.test_torch_setup import jax_scenario, port_configs

B, T = 8, 10


@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    s.update(tpath=interop.path_data(s["path"]),
             tsegs=interop.segment_candidates(s["segs"]),
             tgrid=interop.grid_map(s["grid"]))
    return s


def _configs(sc, solver_kw=None, **overrides):
    """JAX and port configs with the same overrides (``solver_kw`` goes to
    each side's own SolverConfig), the port's table and the jitted JAX
    fleet step."""
    jcfg = dataclasses.replace(sc["mpc_cfg"], **overrides)
    tmodel, tcfg = port_configs(**overrides)
    if solver_kw:
        jcfg = dataclasses.replace(
            jcfg, solver=dataclasses.replace(jcfg.solver, **solver_kw))
        tcfg = dataclasses.replace(
            tcfg, solver=dataclasses.replace(tcfg.solver, **solver_kw))
    table = build_horizon_table(sc["tpath"], sc["tsegs"], tcfg)
    jstep = jax.jit(lambda st: _sim_step_batched(
        st, sc["path"], sc["grid"], jcfg, sc["model_cfg"], sc["segs"]))
    return jcfg, tcfg, tmodel, table, jstep


def _starts(sc, jcfg, seed=3):
    wp, ey = jfeasible(sc["grid"], sc["path"], jcfg, sc["model_cfg"], B,
                       np.random.default_rng(seed))
    return jinit_fleet(sc["path"], jcfg.N, B, e_y0=ey, wp_id0=wp)


def test_slice_per_step_strictly_convex(sc):
    jcfg, tcfg, tmodel, table, jstep = _configs(sc, R=(0.5, 0.01))
    jst = _starts(sc, jcfg)
    fields = ("x", "y", "psi", "v", "s", "e_y")
    d = {f: [] for f in fields}
    ok_t, ok_j, rp_t, rp_j = [], [], [], []
    for _ in range(T):
        pst = interop.car_state(jst)
        pst.solver.rho = torch.full_like(pst.solver.rho, tcfg.solver.rho)
        _, log = tsim._post_control(
            mpc_step_batched(pst, sc["tpath"], tcfg, tmodel, table),
            sc["tpath"], tmodel)
        jst, jlog = jstep(jst)
        for f in fields:
            d[f].append(np.abs(getattr(log, f).numpy()
                               - np.asarray(getattr(jlog, f))))
        ok_t.append(log.ok.numpy())
        ok_j.append(np.asarray(jlog.ok))
        rp_t.append(log.r_prim.numpy())
        rp_j.append(np.asarray(jlog.r_prim))
    d = {f: np.stack(v) for f, v in d.items()}
    ok_t, ok_j = np.stack(ok_t), np.stack(ok_j)
    rp_t, rp_j = np.stack(rp_t), np.stack(rp_j)

    # acceptance: identical except borderline residuals around feas_tol
    tol = tcfg.feas_tol
    borderline = ((np.minimum(rp_t, rp_j) > 0.5 * tol)
                  & (np.maximum(rp_t, rp_j) < 2.0 * tol))
    assert ((ok_t == ok_j) | borderline).all()
    assert (ok_t == ok_j).mean() >= 0.95
    both = ok_t & ok_j
    assert both.mean() > 0.9

    # e_y (measured before the solve) on every lane-step
    assert d["e_y"].max() <= 1e-3
    # the plant's next pose and progress wherever both accepted: 1e-3 on
    # the typical step, the unconverged tail bounded (module docstring)
    for f in ("x", "y", "s"):
        df = d[f][both]
        assert (df <= 1e-3).mean() >= 0.95, (f, (df <= 1e-3).mean())
        assert np.median(df) <= 1e-4 and df.max() <= 1e-2, (f, df.max())
    for f, frac, band in (("v", 0.85, 1e-1), ("psi", 0.90, 5e-2)):
        df = d[f][both]
        assert (df <= 1e-3).mean() >= frac, (f, (df <= 1e-3).mean())
        assert np.median(df) <= 2e-4 and df.max() <= band, (f, df.max())


def test_slice_free_running_cost_flat(sc):
    """Default (cost-flat kappa) weights, both rollouts free-running from
    the same starts: acceptance and progress agree (elementwise controls
    are ill-posed there, ROADMAP Queue 3).  The JAX side resumes its
    carried rho, as the fused solve does."""
    jcfg, tcfg, tmodel, table, jstep = _configs(
        sc, solver_kw=dict(carry_rho=True))
    jst = _starts(sc, jcfg)
    res = tsim.simulate_fleet(sc["tgrid"], sc["tpath"], tcfg, tmodel,
                              SimConfig(max_steps=T), interop.car_state(jst),
                              table=table)
    s0 = np.asarray(jst.s)
    jok = []
    for _ in range(T):
        jst, jlog = jstep(jst)
        jok.append(np.asarray(jlog.ok))
    jok = np.stack(jok)
    tok = res.log.ok.numpy()
    assert tok.shape == jok.shape == (T, B)
    assert abs(int(tok.sum()) - int(jok.sum())) <= 2, (tok.sum(), jok.sum())
    assert (tok == jok).mean() >= 0.95, (tok == jok).mean()
    # per-lane progress over 10 steps (~0.45 m): measured median 3.5e-4 m,
    # worst lane 1.3e-2 m (a pinch point taken at a different speed)
    prog_t = res.final_state.s.numpy() - s0
    prog_j = np.asarray(jst.s) - s0
    dp = np.abs(prog_t - prog_j)
    assert np.median(dp) <= 1e-3 and dp.max() <= 3e-2, dp
    assert prog_t.mean() > 0.5 * T * 0.05 * 0.9  # ~0.9 m/s fleet speed
    assert not res.final_state.failed.any()


def test_simulate_closed_loop_single_car(sc):
    """The single-car entry point is the fleet path at batch 1."""
    tmodel, tcfg = port_configs()
    out = tsim.simulate_closed_loop(sc["tgrid"], sc["tpath"], tcfg, tmodel,
                                    SimConfig(max_steps=4))
    assert out.log.x.shape == (4,) and out.final_state.batch == 1
    assert out.log.ok.all() and (out.log.v > 0).all()
    assert float(out.final_state.s[0]) > 0.1
    with pytest.raises(ValueError):
        tsim.simulate_closed_loop(
            sc["tgrid"], sc["tpath"], tcfg, tmodel, SimConfig(max_steps=1),
            state0=tsim.init_fleet(sc["tpath"], tcfg.N, 2))


def test_dynamic_grid_is_refused(sc):
    tmodel, tcfg = port_configs()
    with pytest.raises(NotImplementedError):
        tsim.simulate_fleet(sc["tgrid"], sc["tpath"], tcfg, tmodel,
                            SimConfig(max_steps=1, static_grid=False),
                            tsim.init_fleet(sc["tpath"], tcfg.N, 1))


def test_interop_round_trip(sc):
    """JAX fleet state -> port tensors -> numpy reproduces every field."""
    jst = _starts(sc, sc["mpc_cfg"])
    back = interop.to_numpy(interop.car_state(jst))
    for f in ("x", "y", "psi", "s", "wp_id", "u_seq", "done", "failed",
              "infeasibility_count"):
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(jst, f)))
    for f in ("X", "U", "Zx", "Yeq", "rho"):
        np.testing.assert_array_equal(getattr(back.solver, f),
                                      np.asarray(getattr(jst.solver, f)))
