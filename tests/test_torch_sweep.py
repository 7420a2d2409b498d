"""Port parity, the variants on the main path: per-lane weight sweeps
(``WeightSet``, kernel K3's plain version), the escalation pass and the
Real_Track preset, against the JAX package on the CPU.

K3's plain version (``solve_ltv_qp_structured``) follows the TPU entry
``solve_ltv_qp_pallas``, which differs from the XLA ``solve_ltv_qp`` the
JAX package runs on the CPU in two stated ways: it resumes the carried rho
(the JAX side runs with ``carry_rho=True`` here), and its ``eps_d`` uses
max(|q_x|, |q_u|) where the XLA solver uses max(|q|, |A_eq' y|).  The
second makes the port's dual tolerance the tighter one, so a lane SOLVED in
the port is SOLVED in JAX, and not always the other way round.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multi_purpose_mpc_tpu.config as jcfgmod
from multi_purpose_mpc_tpu.models.bicycle import init_car_state as jinit
from multi_purpose_mpc_tpu.mpc import (WeightSet as JWeightSet,
                                       escalate_rejects as jescalate,
                                       mpc_corridor as jcorridor,
                                       mpc_locate as jlocate,
                                       mpc_pre_solve as jpre_solve)
from multi_purpose_mpc_tpu.ops.constraints import extract_all_segments as jsegs
from multi_purpose_mpc_tpu.ops.ltv_qp import (LTVSolution as JLTVSolution,
                                              SolverCarry as JSolverCarry,
                                              solve_ltv_qp as jsolve)
from multi_purpose_mpc_tpu.ops.path import build_reference_path as jbuild_path
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile as jspeed
from multi_purpose_mpc_tpu.simulation import _sim_step_batched as jstep_batched
from multi_purpose_mpc_tpu.utils.maps import load_grid_map as jload

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import SimConfig, real_track_preset
from multi_purpose_mpc_tpu_torch.mpc import (WeightSet, assemble_ltv_qp,
                                             escalate_rejects,
                                             kappa_predictions,
                                             mpc_step_batched,
                                             weights_from_config)
from multi_purpose_mpc_tpu_torch.ops.admm_cuda import solve_ltv_qp_structured
from multi_purpose_mpc_tpu_torch.ops.constraints import Corridor
from multi_purpose_mpc_tpu_torch.ops.horizon_table import build_horizon_table
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import LTVQP, LTVSolution, SolverCarry
from tests.test_torch_setup import ASSETS, jax_scenario, port_configs

# tests/test_sweep.py's rows (Q | R | QN): reference tracking and strictly
# convex, and a second strictly convex row
ROW_REF = (1.0, 0.0, 0.0, 0.5, 0.0, 1.0, 0.0, 0.0)
ROW_CONVEX = (1.0, 0.1, 0.0, 0.5, 0.01, 1.0, 0.1, 0.0)
ROW_CONVEX2 = (2.0, 0.1, 0.0, 0.5, 0.01, 2.0, 0.1, 0.0)


def _rows_ws(rows) -> WeightSet:
    a = np.asarray(rows, np.float32)
    return WeightSet(Q=torch.tensor(a[:, 0:3]), R=torch.tensor(a[:, 3:5]),
                     QN=torch.tensor(a[:, 5:8]))


def _rows_jws(rows) -> JWeightSet:
    a = np.asarray(rows, np.float32)
    return JWeightSet(Q=jnp.asarray(a[:, 0:3]), R=jnp.asarray(a[:, 3:5]),
                      QN=jnp.asarray(a[:, 5:8]))


@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    model, cfg = port_configs()
    s.update(tpath=interop.path_data(s["path"]),
             tgrid=interop.grid_map(s["grid"]), tmodel=model, tcfg=cfg)
    s["table"] = build_horizon_table(s["tpath"],
                                     interop.segment_candidates(s["segs"]),
                                     cfg)
    return s


def _fleet(sc, B, seed, e_y_scale=0.02):
    rng = np.random.default_rng(seed)
    return tsim.init_fleet(
        sc["tpath"], sc["tcfg"].N, B,
        e_y0=torch.tensor(rng.uniform(-e_y_scale, e_y_scale, B),
                          dtype=torch.float32),
        wp_id0=torch.tensor(rng.integers(0, sc["tpath"].n_wp, B),
                            dtype=torch.int32))


def _jax_weighted_qps(sc, rows, e_y, wp, carry_rho=True):
    """Per-lane weighted QPs through the JAX pipeline (XLA branch) and its
    vmapped solve_ltv_qp from a fresh carry."""
    jp, cfg, mo = sc["path"], sc["mpc_cfg"], sc["model_cfg"]
    scfg = dataclasses.replace(cfg.solver, carry_rho=carry_rho)

    @jax.jit
    def pipeline(e_y, wp, ws):
        states = jax.vmap(lambda e, w: jinit(jp, cfg.N, e_y=e, wp_id=w))(e_y, wp)
        located = jax.vmap(lambda s: jlocate(s, jp))(states)
        cor = jax.vmap(lambda w: jcorridor(w, jp, sc["grid"], cfg, mo,
                                           sc["segs"]))(located[0])
        qp, aux = jax.vmap(lambda s, loc, c, w: jpre_solve(
            s, jp, sc["grid"], cfg, mo, sc["segs"], located=loc, corridor=c,
            weights=w))(states, located, cor, ws)
        ref = jax.vmap(lambda q, w: jsolve(q, scfg, warm=w))(qp, states.solver)
        return states, located, cor, qp, ref

    return pipeline(jnp.asarray(e_y, jnp.float32), jnp.asarray(wp, jnp.int32),
                    _rows_jws(rows))


def test_weighted_assembly_matches_jax(sc):
    """Per-lane weighted assembly against the JAX package's, the weights
    carried across with interop.weight_set."""
    B = 6
    rows = [ROW_REF, ROW_CONVEX, ROW_CONVEX2] * 2
    i = np.arange(B)
    states, located, cor, qp, _ = _jax_weighted_qps(sc, rows, 0.03 * (i - 3),
                                                    29 * i)
    tp = sc["tpath"]
    st = interop.car_state(states)
    wp, e_y, e_psi = (torch.tensor(np.asarray(a)) for a in located)
    idx = (wp.long()[:, None] + torch.arange(30)[None, :]) % tp.n_wp
    horizon = (tp.v_ref[idx], tp.kappa[idx], tp.seg_dist[idx])
    corridor = Corridor(*(torch.tensor(np.asarray(a)) for a in cor))
    tqp = assemble_ltv_qp(sc["tcfg"], sc["tmodel"], e_y, e_psi,
                          kappa_predictions(st.u_seq, 30), corridor, horizon,
                          weights=interop.weight_set(_rows_jws(rows)))
    for f in ("A", "B", "beq", "q_x", "q_u", "P_x", "P_u", "lx", "ux", "lu",
              "uu"):
        np.testing.assert_allclose(getattr(tqp, f).numpy(),
                                   np.asarray(getattr(qp, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def _to_port_qp(jqp) -> LTVQP:
    return LTVQP(**{k: torch.tensor(np.asarray(getattr(jqp, k)))
                    for k in LTVQP.__dataclass_fields__})


@pytest.mark.parametrize("case", ["centred", "off_corridor"])
def test_k3_plain_matches_jax_solve(sc, case):
    """K3's plain version on per-lane weighted QPs against the JAX
    structured solver (carry_rho=True), at K1's bars: r_prim 1e-4, the
    speed command 3e-3 where both accept, acceptance identical; statuses
    agree up to the eps_d difference (module docstring)."""
    B = 8
    rows = [ROW_REF, ROW_CONVEX, ROW_CONVEX2, jcfg_time_optimal_row()] * 2
    i = np.arange(B)
    if case == "centred":
        e_y, wp = 0.005 * i, 13 * i
    else:
        e_y, wp = 0.04 * (i - 4), 23 * i
    states, _, _, qp, ref = _jax_weighted_qps(sc, rows, e_y, wp)
    sol = solve_ltv_qp_structured(_to_port_qp(qp),
                                  interop.solver_carry(states.solver),
                                  sc["tcfg"].solver)
    st_t, st_j = sol.status.numpy(), np.asarray(ref.status)
    assert ((st_t == st_j) | ((st_t == 1) & (st_j == 0))).all(), (st_t, st_j)
    assert (st_t == st_j).mean() >= 0.75
    np.testing.assert_allclose(sol.r_prim.numpy(), np.asarray(ref.r_prim),
                               atol=1e-4)
    feas = sc["tcfg"].feas_tol
    acc_t, acc_j = sol.r_prim.numpy() <= feas, np.asarray(ref.r_prim) <= feas
    np.testing.assert_array_equal(acc_t, acc_j)
    d_v0 = np.abs(sol.U[:, 0, 0].numpy() - np.asarray(ref.U[:, 0, 0]))
    assert d_v0[acc_t].max() <= 3e-3, d_v0
    assert (sol.carry.rho > 0).all() and torch.isfinite(sol.carry.rho).all()


def jcfg_time_optimal_row():
    """config.time_optimal_config's weights as a row."""
    c = jcfgmod.time_optimal_config(jcfgmod.MPCConfig())
    return tuple(c.Q) + tuple(c.R) + tuple(c.QN)


def test_uniform_sweep_matches_plain_fleet(sc):
    """Every lane carrying the config weights: the sweep (per-lane assembly
    + K3 plain) against the plain fleet (K1 plain), free-running.  The two
    assemble the same QP with a different operation order, so on the
    cost-flat reference weights they agree within the solver's accuracy
    class (the bands the JAX package holds its two solver tiers to:
    |dv| < 0.05, |ds_final| < 0.1), not bitwise."""
    B, T = 4, 4
    cfg, model = sc["tcfg"], sc["tmodel"]
    fleet0 = tsim.init_fleet(sc["tpath"], cfg.N, B,
                             e_y0=torch.linspace(-0.02, 0.02, B))
    sim = SimConfig(max_steps=T)
    kw = dict(grid=sc["tgrid"], path=sc["tpath"], cfg=cfg, model=model,
              sim=sim, state0=fleet0, table=sc["table"])
    plain = tsim.simulate_fleet(**kw)
    ws = WeightSet(*(w.expand(B, -1)
                     for w in weights_from_config(cfg, device="cpu")))
    swept = tsim.simulate_fleet(weights=ws, **kw)
    assert (swept.log.ok == plain.log.ok).float().mean() >= 0.95
    assert float((swept.log.v - plain.log.v).abs().max()) < 0.05
    assert float((swept.final_state.s - plain.final_state.s).abs().max()) < 0.1
    assert not swept.final_state.failed.any()


def test_sweep_lane_matches_per_config_run(sc):
    """Lane i of a heterogeneous sweep == a plain fleet run whose config
    carries lane i's weights (tests/test_sweep.py's check, on strictly
    convex rows, where the QP is well determined): x and v within the
    1e-3 trajectory bar, acceptance identical."""
    T = 4
    cfg, model = sc["tcfg"], sc["tmodel"]
    rows = [ROW_CONVEX, ROW_CONVEX2]
    fleet0 = tsim.init_fleet(sc["tpath"], cfg.N, len(rows))
    sim = SimConfig(max_steps=T)
    swept = tsim.simulate_fleet(sc["tgrid"], sc["tpath"], cfg, model, sim,
                                fleet0, table=sc["table"],
                                weights=_rows_ws(rows))
    for i, r in enumerate(rows):
        cfg_i = dataclasses.replace(cfg, Q=r[0:3], R=r[3:5], QN=r[5:8])
        lane = tsim.init_fleet(sc["tpath"], cfg.N, 1)
        plain = tsim.simulate_fleet(sc["tgrid"], sc["tpath"], cfg_i, model,
                                    sim, lane)
        np.testing.assert_allclose(swept.log.x[:, i].numpy(),
                                   plain.log.x[:, 0].numpy(), atol=1e-3)
        np.testing.assert_allclose(swept.log.v[:, i].numpy(),
                                   plain.log.v[:, 0].numpy(), atol=1e-3)
        np.testing.assert_array_equal(swept.log.ok[:, i].numpy(),
                                      plain.log.ok[:, 0].numpy())


def test_partial_weightset_falls_back_per_leaf(sc):
    B, T = 2, 2
    cfg = sc["tcfg"]
    fleet0 = tsim.init_fleet(sc["tpath"], cfg.N, B)
    full = WeightSet(*(w.expand(B, -1)
                       for w in weights_from_config(cfg, device="cpu")))
    kw = dict(grid=sc["tgrid"], path=sc["tpath"], cfg=cfg,
              model=sc["tmodel"], sim=SimConfig(max_steps=T), state0=fleet0,
              table=sc["table"])
    a = tsim.simulate_fleet(weights=full, **kw)
    b = tsim.simulate_fleet(weights=WeightSet(Q=full.Q, R=None, QN=None), **kw)
    assert torch.equal(a.log.x, b.log.x)


def test_misbatched_weightset_raises(sc):
    """_validate_weights: the JAX package's ValueError messages."""
    cfg = sc["tcfg"]
    fleet0 = tsim.init_fleet(sc["tpath"], cfg.N, 4)
    kw = dict(grid=sc["tgrid"], path=sc["tpath"], cfg=cfg,
              model=sc["tmodel"], sim=SimConfig(max_steps=2), state0=fleet0)
    bad = WeightSet(Q=torch.ones((3, 3)), R=torch.ones((4, 2)),
                    QN=torch.ones((4, 3)))
    with pytest.raises(ValueError, match=r"WeightSet.Q must have shape "
                                         r"\(4, 3\) to match the fleet "
                                         r"batch; got \(3, 3\)"):
        tsim.simulate_fleet(weights=bad, **kw)
    with pytest.raises(ValueError, match="WeightSet.Q"):
        tsim.simulate_fleet(weights=weights_from_config(cfg, device="cpu"), **kw)


def _solution(rng, B, N, mod):
    """A random solution in both packages' types, from the same numbers."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    c = dict(X=f32(B, N + 1, 3), U=f32(B, N, 2), Zx=f32(B, N + 1, 3),
             Zu=f32(B, N, 2), Yeq=f32(B, N + 1, 3), Yx=f32(B, N + 1, 3),
             Yu=f32(B, N, 2), rho=rng.uniform(0.01, 1.0, B).astype(np.float32))
    s = dict(X=f32(B, N + 1, 3), U=f32(B, N, 2),
             status=rng.integers(0, 3, B).astype(np.int32),
             r_prim=rng.uniform(0.0, 0.02, B).astype(np.float32),
             r_dual=rng.uniform(0.0, 0.02, B).astype(np.float32))
    if mod is jnp:
        return JLTVSolution(**{k: jnp.asarray(v) for k, v in s.items()},
                            carry=JSolverCarry(**{k: jnp.asarray(v)
                                                  for k, v in c.items()}))
    return LTVSolution(**{k: torch.tensor(v) for k, v in s.items()},
                       carry=SolverCarry(**{k: torch.tensor(v)
                                            for k, v in c.items()}))


def test_escalate_rejects_matches_jax_and_merges_the_carry():
    """Same solution, floor and re-solve results through both packages'
    escalate_rejects: every merged field equal, the warm-start carry
    included (the JAX code merges it, whatever its docstring says; the
    port follows the code)."""
    B, N, k, feas = 12, 4, 5, 5e-3
    floor = np.zeros(B, np.float32)
    floor[:3] = 0.01  # certified-infeasible lanes: never escalated
    res = {}
    for mod in (jnp, torch):
        main = _solution(np.random.default_rng(1), B, N, mod)
        sub_all = _solution(np.random.default_rng(2), B, N, mod)
        take = ((lambda a, i: jnp.take(a, i, axis=0)) if mod is jnp
                else (lambda a, i: a[i]))

        def resolve(idx, warm, sub_all=sub_all, take=take):
            sub = jax.tree.map(lambda a: take(a, idx), sub_all) \
                if mod is jnp else LTVSolution(
                    *(take(a, idx) for a in sub_all[:5]),
                    carry=sub_all.carry.take(idx))
            return sub

        esc = jescalate if mod is jnp else escalate_rejects
        fl = jnp.asarray(floor) if mod is jnp else torch.tensor(floor)
        res[mod] = esc(main, fl, feas, k, resolve)
    jout, tout = res[jnp], res[torch]
    for f in ("X", "U", "status", "r_prim", "r_dual"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f)), err_msg=f)
    for f in ("X", "U", "Zx", "Zu", "Yeq", "Yx", "Yu", "rho"):
        np.testing.assert_array_equal(getattr(tout.carry, f).numpy(),
                                      np.asarray(getattr(jout.carry, f)),
                                      err_msg=f)
    main = _solution(np.random.default_rng(1), B, N, torch)
    merged = (tout.r_prim != main.r_prim).numpy()
    assert merged.any() and not merged[:3].any()
    # the carry of a merged lane is the re-solve's, not the main solve's
    sub = _solution(np.random.default_rng(2), B, N, torch)
    assert torch.equal(tout.carry.X[merged], sub.carry.X[merged])


def test_escalation_accept_rate_not_lower(sc):
    """tests/test_acceptance.py's check through the port: the accept rate
    with escalation >= without, and at step 0 (identical states) no lane
    accepted without it is rejected with it."""
    B, T = 16, 3
    cfg_off, model = sc["tcfg"], sc["tmodel"]
    cfg_on = dataclasses.replace(
        cfg_off, solver=dataclasses.replace(cfg_off.solver, escalate_lanes=8))
    fleet0 = _fleet(sc, B, 3, e_y_scale=0.05)
    kw = dict(grid=sc["tgrid"], path=sc["tpath"], model=model,
              sim=SimConfig(max_steps=T), state0=fleet0, table=sc["table"])
    on = tsim.simulate_fleet(cfg=cfg_on, **kw)
    off = tsim.simulate_fleet(cfg=cfg_off, **kw)
    ok_on, ok_off = on.log.ok.numpy(), off.log.ok.numpy()
    assert ok_on[on.log.active.numpy()].mean() \
        >= ok_off[off.log.active.numpy()].mean()
    assert (ok_on[0] | ~ok_off[0]).all()


@pytest.fixture(scope="module")
def real_track():
    map_cfg, path_cfg, model, cfg, speed_cfg, _ = jcfgmod.real_track_preset(
        asset_dir=ASSETS)
    grid = jload(map_cfg)
    path = jspeed(jbuild_path(grid, path_cfg), speed_cfg)
    segs = jsegs(grid, path, 2.0 * model.safety_margin,
                 n_samples=cfg.n_scan_samples, max_segments=cfg.max_segments)
    return dict(grid=grid, path=path, segs=segs, model=model, cfg=cfg)


def test_real_track_fleet_per_step_vs_jax(real_track):
    """Real_Track (non-circular path, clamped horizon), B = 4 lanes drawn as
    bench.py draws them, 5 steps, per-step protocol of
    tests/test_torch_slice.py with strictly convex weights: e_y to 1e-3,
    acceptance equal, the next pose and speed command within 1e-3."""
    rt = real_track
    B, T = 4, 5
    jcfg = dataclasses.replace(rt["cfg"], R=(0.5, 0.01))
    _, _, tmodel, tcfg, _, _ = real_track_preset(asset_dir=ASSETS)
    tcfg = dataclasses.replace(tcfg, R=(0.5, 0.01))
    tpath = interop.path_data(rt["path"])
    table = build_horizon_table(tpath, interop.segment_candidates(rt["segs"]),
                                tcfg)
    rng = np.random.default_rng(6)
    e_y0 = rng.uniform(-0.1, 0.1, B).astype(np.float32)
    wp0 = rng.integers(0, tpath.n_wp // 2, B).astype(np.int32)
    jst = jax.vmap(lambda e, w: jinit(rt["path"], jcfg.N, e_y=e, wp_id=w))(
        jnp.asarray(e_y0), jnp.asarray(wp0))
    jstep = jax.jit(lambda st: jstep_batched(st, rt["path"], rt["grid"], jcfg,
                                             rt["model"], rt["segs"]))
    for _ in range(T):
        pst = interop.car_state(jst)
        pst.solver.rho = torch.full_like(pst.solver.rho, tcfg.solver.rho)
        _, log = tsim._post_control(
            mpc_step_batched(pst, tpath, tcfg, tmodel, table), tpath, tmodel)
        jst, jlog = jstep(jst)
        np.testing.assert_array_equal(log.ok.numpy(), np.asarray(jlog.ok))
        for f in ("e_y", "x", "y", "s", "psi", "v"):
            np.testing.assert_allclose(getattr(log, f).numpy(),
                                       np.asarray(getattr(jlog, f)),
                                       atol=1e-3, err_msg=f)
    assert not np.asarray(jst.failed).any()
