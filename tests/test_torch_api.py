"""Port parity, the reference-mirroring object API and the single-lane step:
``multi_purpose_mpc_tpu_torch.api`` (Map, ReferencePath, BicycleModel, MPC,
LidarModel), ``constraints.update_path_constraints``, ``mpc.mpc_step`` and
``mpc.predict_world_positions`` against the JAX package's, both on the CPU
on the Sim_Track preset (its 9 obstacles).  The port's objects are built
with ``device="cpu"``; downstream of the map, the JAX path is carried
across (``interop.path_data``: the static borders of the two packages can
differ by one 5 mm cell, tests/test_torch_setup.py).

Bars and their reasons:

* Map data, ``w2m`` / ``m2w``, obstacles, boundaries and the map
  write-back are integer work on the same data: bitwise.
* ``update_path_constraints``: the free segments are bitwise equal to the
  JAX function's own (its ``free_segments`` on the same horizon).  The
  corridor is selected by kernel K2's plain version, which takes the
  side of a border from the sign of a cross product with the table's
  float64-rounded cos / sin and its distance by ``sqrt``, where the JAX
  function wraps ``atan2`` and takes ``hypot``: the two part in the last
  bits (measured 1.8e-7 at most on these cases; tests/test_torch_corridor.py
  holds the twin against the JAX TPU kernel).  Held at 1e-6.
* ``mpc_step``: its QP against JAX ``mpc_pre_solve`` given the same
  corridor at rtol 1e-6 / atol 1e-7 (tests/test_torch_sweep.py:135).  Its
  solution against JAX ``mpc_pre_solve`` + ``solve_ltv_qp_pallas`` (K3's
  TPU counterpart) in interpret mode, with rolled stage loops (the form
  the TPU kernel takes above N = 32; 24 s to trace here instead of 220 s),
  at tests/test_torch_sweep.py's K3 bars (r_prim 1e-4, status and
  acceptance equal, the speed command 3e-3 where both accept), from each
  state with a fresh solver carry.  From the carried iterate (adapted rho
  up to ~2e4) the fixed-budget float32 solve is not reproducible to that
  bar even between the TPU kernel's own two forms: rolled and unrolled
  stage loops measured r_prim 3.7e-4 against 2.5e-4 and v 0.9505 against
  0.9556 on the states of this file.  The carried states are held against
  JAX ``mpc_step`` (its XLA solver, which restarts rho, so the port's
  carried rho is reset as in tests/test_torch_slice.py) at that file's
  bars for two float32 budget-limited solvers.
* Frame transforms, the plant and ``predict_world_positions``: the same
  float32 formulas, atol 1e-6 / 1e-5.
* ``LidarModel.scan``: tests/test_torch_lidar.py's bars (hit flags on
  >= 99.9 % of beams, ranges within 4.8e-7 m where both hit the same
  cell).
* The two-call loop, 40 steps under tests/test_parity.py's per-step
  protocol (each step starts both APIs from the JAX state), on
  tests/test_torch_slice.py's strictly convex weights R = diag(0.5,
  0.01): acceptance equal on every step, and that file's per-step bars
  for the pose, progress and e_y; for v and psi' its bands, with medians
  at the spread of the JAX package's own two solver entries on these
  states (the test says which).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multi_purpose_mpc_tpu as J
from multi_purpose_mpc_tpu.models.bicycle import spatial_derivatives as jspatial
from multi_purpose_mpc_tpu.mpc import mpc_locate as jlocate
from multi_purpose_mpc_tpu.mpc import mpc_pre_solve as jpre_solve
from multi_purpose_mpc_tpu.mpc import mpc_step as jmpc_step
from multi_purpose_mpc_tpu.mpc import predict_world_positions as jpredict
from multi_purpose_mpc_tpu.ops import constraints as jcons
from multi_purpose_mpc_tpu.ops.admm_pallas import solve_ltv_qp_pallas
from multi_purpose_mpc_tpu.ops.ltv_qp import init_solver_carry as jinit_carry
from multi_purpose_mpc_tpu.ops.path import gather_waypoint_index as jgather

import multi_purpose_mpc_tpu_torch as P
from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch.config import sim_track_preset
from multi_purpose_mpc_tpu_torch.models.bicycle import (horizon_indices,
                                                        spatial_derivatives)
from multi_purpose_mpc_tpu_torch.mpc import (mpc_locate, mpc_pre_solve,
                                             mpc_step, predict_world_positions)
from multi_purpose_mpc_tpu_torch.ops import constraints as tcons
from multi_purpose_mpc_tpu_torch.ops import grid as tgrid_ops
from multi_purpose_mpc_tpu_torch.ops.corridor_extract import fleet_dynamic_segments
from multi_purpose_mpc_tpu_torch.ops.path import w2m_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "maps")
MAP_CFG, PATH_CFG, MODEL_CFG, MPC_CFG, SPEED_CFG, OBSTACLES = sim_track_preset(
    asset_dir=ASSETS)
SM = MODEL_CFG.safety_margin
R_CONVEX = (0.5, 0.01)
LOOP_STEPS = 40
STATE_STEPS = (0, 10, 20, 30)  # mpc_step's states: before these loop steps
SPEED = {"a_min": -0.1, "a_max": 0.5, "v_min": 0.0, "v_max": 1.0,
         "ay_max": 4.0}


def _map(mod, obstacles=OBSTACLES, **kw):
    m = mod.Map(MAP_CFG.file_path, MAP_CFG.origin, MAP_CFG.resolution, **kw)
    rp = mod.ReferencePath(m, PATH_CFG.wp_x, PATH_CFG.wp_y, PATH_CFG.resolution,
                           PATH_CFG.smoothing_distance, PATH_CFG.max_width,
                           PATH_CFG.circular)
    m.add_obstacles([mod.Obstacle(*o) for o in obstacles])
    return m, rp


def _controller(mod, rp, R=R_CONVEX):
    car = mod.BicycleModel(rp, MODEL_CFG.length, MODEL_CFG.width, MODEL_CFG.Ts)
    kmax = np.tan(MPC_CFG.delta_max) / car.length
    ctrl = mod.MPC(car, MPC_CFG.N, np.diag(MPC_CFG.Q), np.diag(R),
                   np.diag(MPC_CFG.QN),
                   {"xmin": np.full(3, -np.inf), "xmax": np.full(3, np.inf)},
                   {"umin": np.array([0.0, -kmax]),
                    "umax": np.array([MPC_CFG.v_max, kmax])}, MPC_CFG.ay_max)
    rp.compute_speed_profile(SPEED)
    return car, ctrl


def _port_state(jstate, rho=None):
    """A JAX API car state as the port's batch-1 state; ``rho`` resets the
    carried step size."""
    st = interop.car_state(jax.tree.map(lambda a: np.asarray(a)[None], jstate))
    if rho is not None:
        st.solver.rho = torch.full_like(st.solver.rho, rho)
    return st


@pytest.fixture(scope="module")
def api():
    """Both APIs on the preset (ReferencePath built before the obstacles
    are added, as the reference's simulation.py does), the JAX path carried across
    into the port's, and a 40-step JAX two-call loop whose pre-step states
    drive the per-step comparisons."""
    jm, jrp = _map(J)
    tm, trp = _map(P, device="cpu")
    jcar, jmpc = _controller(J, jrp)
    tcar, tmpc = _controller(P, trp)
    trp.path_data = interop.path_data(jrp.path_data)
    states, outs = [], []
    for _ in range(LOOP_STEPS):
        states.append(jcar._state)
        u = jmpc.get_control()
        jcar.drive(u)
        outs.append((u, jcar._state))
    return dict(jm=jm, jrp=jrp, tm=tm, trp=trp, jcar=jcar, jmpc=jmpc,
                tcar=tcar, tmpc=tmpc, states=states, outs=outs)


# ---------------------------------------------------------------------------
# Map, path, waypoints
# ---------------------------------------------------------------------------

def test_map_bitwise(api):
    jm, tm = api["jm"], api["tm"]
    assert tm.data.dtype == jm.data.dtype == np.int8
    np.testing.assert_array_equal(tm.data, jm.data)
    np.testing.assert_array_equal(tm.grid.occ.numpy(), np.asarray(jm.grid.occ))
    assert tm.device == torch.device("cpu")
    assert (tm.height, tm.width) == (jm.height, jm.width)
    for x, y in ((-0.3, -1.1), (-1.0, -2.0), (0.7325, 0.4975), (1.49, 0.49)):
        assert tm.w2m(x, y) == jm.w2m(x, y)
        assert tm.m2w(*tm.w2m(x, y)) == jm.m2w(*jm.w2m(x, y))
    fresh = P.Map(MAP_CFG.file_path, MAP_CFG.origin, MAP_CFG.resolution,
                  device="cpu")
    assert (fresh.data != tm.data).sum() > 1000  # the obstacles went in


BOUNDARIES = [((-0.02, -1.72), (0.5, 0.0)), ((0.43, -0.07), (1.5, 0.49)),
              ((-1.0, -2.0), (1.49, 0.49)), ((0.2, -1.2), (0.2, -1.2)),
              ((-1.3, -0.3), (0.1, -0.3))]


def test_add_boundary_bitwise():
    """Map.add_boundary (1024 samples a segment, off-map ends clipped) and
    grid.add_boundary at a sample count short of the segment's pixel
    length, against the JAX package."""
    jm = J.Map(MAP_CFG.file_path, MAP_CFG.origin, MAP_CFG.resolution)
    tm = P.Map(MAP_CFG.file_path, MAP_CFG.origin, MAP_CFG.resolution,
               device="cpu")
    before = tm.data.copy()
    jm.add_boundary(BOUNDARIES)
    tm.add_boundary(BOUNDARIES)
    np.testing.assert_array_equal(tm.data, jm.data)
    assert (tm.data != before).sum() > 500
    assert tm.boundaries == BOUNDARIES
    starts, ends = [b[0] for b in BOUNDARIES], [b[1] for b in BOUNDARIES]
    j = J.add_boundary(jm.grid, starts, ends, n_samples=64)
    t = tgrid_ops.add_boundary(tm.grid, starts, ends, n_samples=64)
    np.testing.assert_array_equal(t.occ.numpy(), np.asarray(j.occ))
    one = tgrid_ops.add_boundary(tm.grid, BOUNDARIES[0][0], BOUNDARIES[0][1])
    np.testing.assert_array_equal(
        one.occ.numpy(), np.asarray(J.add_boundary(jm.grid, BOUNDARIES[0][0],
                                                   BOUNDARIES[0][1]).occ))


def test_lookup_world_bitwise(api):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.2, 1.7, 400).astype(np.float32)
    y = rng.uniform(-2.2, 0.7, 400).astype(np.float32)
    j = J.ops.grid.lookup_world(api["jm"].grid, jnp.asarray(x), jnp.asarray(y))
    t = tgrid_ops.lookup_world(api["tm"].grid, torch.tensor(x), torch.tensor(y))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert 0 < float(t.mean()) < 1
    for a, b in zip(w2m_pair(api["tm"].grid, torch.tensor(x), torch.tensor(y)),
                    J.ops.path.w2m_pair(api["jm"].grid, jnp.asarray(x),
                                        jnp.asarray(y))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_reference_path_fields():
    """The port's own ReferencePath (not carried across) against the JAX
    one, at tests/test_torch_setup.py's bars for the same fields."""
    jm, jrp = _map(J)
    tm, trp = _map(P, device="cpu")
    assert trp.n_waypoints == jrp.n_waypoints == 200
    assert abs(trp.length - jrp.length) <= 1e-5
    np.testing.assert_allclose(trp.segment_lengths, jrp.segment_lengths,
                               atol=1e-5)
    for f in ("x", "y", "psi", "kappa", "ub", "lb"):
        np.testing.assert_allclose(getattr(trp.path_data, f).numpy(),
                                   np.asarray(getattr(jrp.path_data, f)),
                                   atol=1e-5, err_msg=f)
    cell = MAP_CFG.resolution
    for f in ("border_ub", "border_lb"):
        d = np.abs(getattr(trp.path_data, f).numpy()
                   - np.asarray(getattr(jrp.path_data, f)))
        assert d.max() <= cell + 1e-6, (f, d.max())
    trp.compute_speed_profile(SPEED)
    jrp.compute_speed_profile(SPEED)
    np.testing.assert_allclose(trp.path_data.v_ref.numpy(),
                               np.asarray(jrp.path_data.v_ref), atol=1e-3)
    # the host copies Waypoint reads follow the new path
    assert trp.get_waypoint(7).v_ref == float(trp.path_data.v_ref[7])


def test_waypoints_wrap_and_subtract(api):
    jrp, trp = api["jrp"], api["trp"]
    n = trp.n_waypoints
    for i in (0, 5, n - 1, n, n + 3, 3 * n + 17):
        tw, jw = trp.get_waypoint(i), jrp.get_waypoint(i)
        assert tw._i == jw._i == i % n
        for f in ("x", "y", "psi", "kappa", "v_ref", "lb", "ub"):
            assert isinstance(getattr(tw, f), float)
            assert getattr(tw, f) == getattr(jw, f), (i, f)
        assert tw.static_border_cells == jw.static_border_cells
    for a, b in ((6, 5), (0, n - 1), (120, 57)):
        d_t = trp.get_waypoint(a) - trp.get_waypoint(b)
        assert abs(d_t - (jrp.get_waypoint(a) - jrp.get_waypoint(b))) <= 1e-6
    assert 0.01 < trp.get_waypoint(6) - trp.get_waypoint(5) < 0.1
    assert len(trp.waypoints) == n


# ---------------------------------------------------------------------------
# update_path_constraints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def updated_maps(api):
    """A known map without obstacles after one update_map with a scan of
    the true map (obstacles included) from a pose before the obstacle at
    (-0.3, -1.0), through both APIs from the same scan."""
    jm, _ = _map(J, obstacles=())
    tm, _ = _map(P, obstacles=(), device="cpu")
    pose = P.api.TemporalState(-0.55, -1.5, 0.0)
    jsens = J.LidarModel(FoV=360, range=1.0, resolution=1)
    tsens = P.LidarModel(FoV=360, range=1.0, resolution=1)
    jsens.scan(pose, api["jm"])
    tsens._last_scan = interop.lidar_scan(jsens._last_scan)
    before = tm.data.copy()
    jsens.update_map(pose, jm)
    tsens.update_map(pose, tm)
    return jm, tm, before


@pytest.mark.parametrize("grid", ["obstacles", "after_update_map"])
@pytest.mark.parametrize("N", [12, 30])
@pytest.mark.parametrize("wp", [0, 57, 120, 199])
def test_update_path_constraints_vs_jax(api, updated_maps, grid, N, wp):
    if grid == "obstacles":
        jg, tg = api["jm"].grid, api["tm"].grid
    else:
        jm, tm, _ = updated_maps
        jg, tg = jm.grid, tm.grid
    jp, tp = api["jrp"].path_data, api["trp"].path_data
    ref = jax.jit(jcons.update_path_constraints, static_argnums=(3,))(
        jg, jp, jnp.int32(wp), N, 2.0 * SM, SM)
    out = tcons.update_path_constraints(tg, tp, wp, N, 2.0 * SM, SM)
    for f, a, b in zip(tcons.Corridor._fields, out, ref):
        assert a.shape == (1,) + b.shape, f
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=f)
    # the free segments bitwise: the JAX function's own free_segments
    idx = jgather(jp, jnp.int32(wp), jnp.arange(N))
    jsegs = jax.vmap(lambda a, b: jcons.free_segments(
        jg, a, b, 2.0 * SM, MPC_CFG.n_scan_samples, MPC_CFG.max_segments))(
            jp.border_ub[idx], jp.border_lb[idx])
    scan, _ = tcons.corridor_tables(tg, tp, N, MPC_CFG.n_scan_samples,
                                    MPC_CFG.max_segments)
    tsegs = fleet_dynamic_segments(tg.occ, scan, torch.tensor(
        np.asarray(idx))[None], 2.0 * SM, MPC_CFG.max_segments)
    for a, b in zip(tsegs, jsegs):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))


def test_update_path_constraints_api_and_tables(api, updated_maps):
    """ReferencePath.update_path_constraints returns the function's
    corridor and stores the border cells; the tables are built once per
    path and horizon, and the corridor follows the map it is given."""
    trp, jrp = api["trp"], api["jrp"]
    ub, lb, cells = trp.update_path_constraints(195, 12, 2.0 * SM, SM)
    jub, jlb, jcells = jrp.update_path_constraints(195, 12, 2.0 * SM, SM)
    np.testing.assert_allclose(ub, jub, atol=1e-6)
    np.testing.assert_allclose(lb, jlb, atol=1e-6)
    assert len(cells) == 12 and (ub >= lb).all()
    assert sorted(trp._dynamic_border_cells) == sorted(
        jrp._dynamic_border_cells)
    assert trp.get_waypoint(198).dynamic_border_cells == cells[3]
    tp, tg = trp.path_data, api["tm"].grid
    a = tcons.corridor_tables(tg, tp, 12, 128, 8)
    assert all(x is y for x, y in zip(a, tcons.corridor_tables(tg, tp, 12,
                                                               128, 8)))
    b = tcons.corridor_tables(tg, tp, 30, 128, 8)
    assert b[1].shape == (200, 30, 50) and b[1] is not a[1]
    # the same path on the updated (obstacle-free + one scan) map
    _, tm, before = updated_maps
    assert (tm.data != before).any()
    c_obst = tcons.update_path_constraints(tg, tp, 100, 30, 2.0 * SM, SM)
    c_upd = tcons.update_path_constraints(tm.grid, tp, 100, 30, 2.0 * SM, SM)
    assert not all(torch.equal(a, b) for a, b in zip(c_obst, c_upd))
    batched = tcons.update_path_constraints(tg, tp, torch.tensor([100, 7]), 30,
                                            2.0 * SM, SM)
    assert torch.equal(batched.ub[0], c_obst.ub[0])


# ---------------------------------------------------------------------------
# mpc_step, predict_world_positions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k3_tpu(api):
    """JAX mpc_pre_solve + solve_ltv_qp_pallas (interpret mode, rolled
    stage loops) at the chosen states with a fresh solver carry, each
    given the port's corridor."""
    jcfg, jp, jg = api["jmpc"].config, api["jrp"].path_data, api["jm"].grid
    tcfg, tp, tg = api["tmpc"].config, api["trp"].path_data, api["tm"].grid
    model = api["jcar"]._model_cfg
    solver = dataclasses.replace(jcfg.solver, rolled_stage_loops=True)
    rows = []
    for k in STATE_STEPS:
        jst = api["states"][k].replace(solver=jinit_carry(jcfg.N))
        pst = _port_state(jst)
        located = mpc_locate(pst, tp)
        corridor = tcons.update_path_constraints(
            tg, tp, located[0] + 1, tcfg.N, 2.0 * SM, SM)
        idx = horizon_indices(tp, located[0], tcfg.N)
        horizon = (tp.v_ref[idx], tp.kappa[idx], tp.seg_dist[idx])
        qp, aux = mpc_pre_solve(pst, tcfg, api["tcar"]._model_cfg, located,
                                corridor, horizon)
        jcor = jcons.Corridor(*(jnp.asarray(c[0].numpy()) for c in corridor))
        jqp, jaux = jpre_solve(jst, jp, jg, jcfg, model,
                               located=jlocate(jst, jp), corridor=jcor)
        batch = lambda t: jax.tree.map(lambda a: a[None], t)
        ref = solve_ltv_qp_pallas(batch(jqp), batch(jst.solver), solver,
                                  lanes=8, interpret=True)
        rows.append(dict(jst=jst, pst=pst, qp=qp, aux=aux, jqp=jqp,
                         jaux=jaux, ref=ref))
    return rows


@pytest.mark.parametrize("k", range(len(STATE_STEPS)))
def test_mpc_step_qp_and_k3_solution(api, k3_tpu, k):
    r = k3_tpu[k]
    for f in ("A", "B", "beq", "q_x", "q_u", "P_x", "P_u", "lx", "ux", "lu",
              "uu"):
        np.testing.assert_allclose(getattr(r["qp"], f)[0].numpy(),
                                   np.asarray(getattr(r["jqp"], f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(r["aux"][4].numpy(), [float(r["jaux"][4])],
                               rtol=1e-6, atol=1e-7)
    tcfg, tp = api["tmpc"].config, api["trp"].path_data
    out = mpc_step(r["pst"], tp, api["tm"].grid, tcfg, api["tcar"]._model_cfg)
    ref = r["ref"]
    # tests/test_torch_sweep.py's K3 bars: status, r_prim 1e-4, acceptance,
    # the speed command 3e-3 where both accept
    assert int(out.status[0]) == int(np.asarray(ref.status)[0])
    np.testing.assert_allclose(out.r_prim.numpy(), np.asarray(ref.r_prim),
                               atol=1e-4)
    feas = tcfg.feas_tol
    assert bool(out.ok[0]) == bool(np.asarray(ref.r_prim)[0] <= feas)
    if bool(out.ok[0]):
        assert abs(float(out.v[0]) - float(ref.U[0, 0, 0])) <= 3e-3
    assert float(out.state.solver.rho[0]) > 0.0
    # predict_world_positions on the TPU kernel's prediction
    jx, jy = jpredict(api["jrp"].path_data, r["jaux"][0], ref.X[0])
    tx, ty = predict_world_positions(tp, out.state.wp_id,
                                     torch.tensor(np.asarray(ref.X)))
    np.testing.assert_allclose(tx[0].numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy), atol=1e-5)
    assert tx.shape == (1, tcfg.N + 1)


def test_mpc_step_vs_jax_mpc_step(api):
    """The port's step (K3's plain version) against JAX mpc_step (XLA
    solver) at the four states, the port's rho reset to cfg.rho as the
    XLA solver's: tests/test_torch_slice.py's acceptance rule and band."""
    tcfg, tp, tg = api["tmpc"].config, api["trp"].path_data, api["tm"].grid
    jcfg, jp, jg = api["jmpc"].config, api["jrp"].path_data, api["jm"].grid
    jstep = jax.jit(lambda s: jmpc_step(s, jp, jg, jcfg,
                                        api["jcar"]._model_cfg))
    model = api["tcar"]._model_cfg
    dv, ok_t, ok_j, rp_t, rp_j = [], [], [], [], []
    for k in STATE_STEPS:
        jst = api["states"][k]
        out = mpc_step(_port_state(jst, tcfg.solver.rho), tp, tg, tcfg, model)
        ref = jstep(jst)
        ok_t.append(bool(out.ok[0]))
        ok_j.append(bool(ref.ok))
        rp_t.append(float(out.r_prim[0]))
        rp_j.append(float(ref.r_prim))
        dv.append(abs(float(out.v[0]) - float(ref.v)))
        assert int(out.state.wp_id[0]) == int(ref.state.wp_id)
        np.testing.assert_allclose(out.corridor.ub[0].numpy(),
                                   np.asarray(ref.corridor.ub), atol=1e-6)
    # the static-grid branch: the precomputed segments of every waypoint,
    # selected by the atan2 formulation, give the same corridor
    segs = tcons.extract_all_segments(tg, tp, 2.0 * SM, tcfg.n_scan_samples,
                                      tcfg.max_segments)
    st = _port_state(api["states"][STATE_STEPS[-1]], tcfg.solver.rho)
    live = mpc_step(st, tp, tg, tcfg, model)
    static = mpc_step(st, tp, tg, tcfg, model, segments=segs)
    for a, b in zip(static.corridor, live.corridor):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert bool(static.ok[0]) == bool(live.ok[0])
    ok_t, ok_j = np.array(ok_t), np.array(ok_j)
    rp_t, rp_j, dv = np.array(rp_t), np.array(rp_j), np.array(dv)
    tol = tcfg.feas_tol
    borderline = ((np.minimum(rp_t, rp_j) > 0.5 * tol)
                  & (np.maximum(rp_t, rp_j) < 2.0 * tol))
    assert ((ok_t == ok_j) | borderline).all()
    both = ok_t & ok_j
    assert both.all(), (ok_t, ok_j)
    # the band; the fractions and medians need more than four states and
    # are held over the 40 of test_two_call_loop_per_step_vs_jax
    assert dv.max() <= 1e-1, dv


# ---------------------------------------------------------------------------
# BicycleModel, LidarModel
# ---------------------------------------------------------------------------

def test_bicycle_model_drive_transforms_set_pose(api):
    jcar, tcar = api["jcar"], api["tcar"]
    saved_j, saved_t = jcar._state, tcar._state
    try:
        jst = api["states"][20]
        jcar._state = jst
        tcar._state = _port_state(jst)
        for u in ((0.8, 0.1), (0.95, -0.3), (0.0, 0.66)):
            jcar.drive(np.array(u))
            tcar.drive(np.array(u))
            for f in ("x", "y", "psi", "s"):
                np.testing.assert_allclose(
                    getattr(tcar.state, f)[0].numpy(),
                    np.asarray(getattr(jcar.state, f)), atol=1e-6, err_msg=f)
        ts, js = tcar.temporal_state, jcar.temporal_state
        assert (ts.x, ts.y, ts.psi) == (js.x, js.y, js.psi)
        wp = api["trp"].get_waypoint(tcar.wp_id + 2)
        jwp = api["jrp"].get_waypoint(jcar.wp_id + 2)
        a, b = tcar.t2s(wp, ts), jcar.t2s(jwp, js)
        assert abs(a.e_y - b.e_y) <= 1e-6 and abs(a.e_psi - b.e_psi) <= 1e-6
        c, d = tcar.s2t(wp, a), jcar.s2t(jwp, b)
        for f in ("x", "y", "psi"):
            assert abs(getattr(c, f) - getattr(d, f)) <= 1e-6, f
        for pose in ((0.5, -1.48, 0.02, None), (-0.3, -0.52, 3.1, None),
                     (1.0, -1.0, 1.5, 4.2)):
            jcar.set_pose(*pose)
            tcar.set_pose(*pose)
            assert tcar.wp_id == jcar.wp_id
            for f in ("s", "e_y", "e_psi"):
                np.testing.assert_allclose(
                    getattr(tcar.state, f)[0].numpy(),
                    np.asarray(getattr(jcar.state, f)), atol=1e-6, err_msg=f)
        tcar.get_current_waypoint()
        jcar.get_current_waypoint()
        assert tcar.wp_id == jcar.wp_id
        assert len(tcar.spatial_state) == 3
        # the spatial-domain derivatives (reference model API)
        rng = np.random.default_rng(2)
        e_y, e_psi, kappa = (rng.uniform(-a, a, 16).astype(np.float32)
                             for a in (0.05, 0.3, 5.0))
        v = rng.uniform(0.2, 1.0, 16).astype(np.float32)
        delta = rng.uniform(-0.6, 0.6, 16).astype(np.float32)
        t = spatial_derivatives(*(torch.tensor(a) for a in (e_y, e_psi, v,
                                                            delta, kappa)),
                                MODEL_CFG.length)
        j = jax.vmap(lambda *a: jspatial(*a, MODEL_CFG.length))(
            e_y, e_psi, v, delta, kappa)
        assert t.shape == (16, 3)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    finally:
        jcar._state, tcar._state = saved_j, saved_t


def test_lidar_scan_and_update_map(api):
    jsens = J.LidarModel(FoV=180, range=2.0, resolution=2)
    tsens = P.LidarModel(FoV=180, range=2.0, resolution=2)
    assert tsens.n_measurements == jsens.n_measurements == 91
    np.testing.assert_allclose(tsens.measurements, jsens.measurements,
                               atol=1e-6)
    jcar, tcar = api["jcar"], api["tcar"]
    saved_j, saved_t = jcar._state, tcar._state
    try:
        hit_eq, both = [], []
        for k in (0, 15, 30):
            jcar._state = api["states"][k]
            tcar._state = _port_state(api["states"][k])
            jm = jsens.scan(jcar, api["jm"])
            tm = tsens.scan(tcar, api["tm"])
            assert tm.shape == jm.shape == (2, 91)
            jhit = np.asarray(jsens._last_scan.hit)
            thit = tsens._last_scan.hit.numpy()
            hit_eq.append(thit == jhit)
            both.append(thit & jhit)
            res = MAP_CFG.resolution
            org = np.asarray(MAP_CFG.origin, np.float64)
            cell = lambda xy: np.floor((np.asarray(xy, np.float64) - org) / res)
            same = (thit & jhit) & (np.abs(
                cell(tsens._last_scan.hit_xy.numpy())
                - cell(jsens._last_scan.hit_xy)).max(-1) == 0)
            np.testing.assert_allclose(tm[1][same], jm[1][same], rtol=0,
                                       atol=4.8e-7)
            # update_map fed the same scan: Map.data equal
            jmap = J.Map(MAP_CFG.file_path, MAP_CFG.origin, MAP_CFG.resolution)
            tmap = P.Map(MAP_CFG.file_path, MAP_CFG.origin, MAP_CFG.resolution,
                         device="cpu")
            tsens._last_scan = interop.lidar_scan(jsens._last_scan)
            for clear in (False, True):
                jsens.update_map(jcar, jmap, clear_free=clear)
                tsens.update_map(tcar, tmap, clear_free=clear)
                np.testing.assert_array_equal(tmap.data, jmap.data)
        assert np.concatenate(hit_eq).mean() >= 0.999
        assert np.concatenate(both).mean() > 0.3
    finally:
        jcar._state, tcar._state = saved_j, saved_t


# ---------------------------------------------------------------------------
# The two-call loop
# ---------------------------------------------------------------------------

def test_two_call_loop_per_step_vs_jax(api):
    """u = mpc.get_control(); car.drive(u) through both APIs, each step
    from the JAX loop's pre-step state (port rho reset to cfg.rho, the
    XLA solver's start), 40 steps."""
    tcar, tmpc = api["tcar"], api["tmpc"]
    rho = tmpc.config.solver.rho
    fields = ("x", "y", "psi", "s", "v", "e_y")
    d = {f: [] for f in fields}
    ok_t, ok_j = [], []
    for k in range(LOOP_STEPS):
        jst = api["states"][k]
        ju, jnext = api["outs"][k]
        tcar._state = _port_state(jst, rho)
        tu = tmpc.get_control()
        t_e_y = float(tcar.state.e_y[0])
        ok_t.append(tmpc.infeasibility_counter == 0)
        tcar.drive(tu)
        ok_j.append(int(jnext.infeasibility_count) == 0)
        for f in ("x", "y", "psi", "s"):
            d[f].append(abs(float(getattr(tcar.state, f)[0])
                            - float(getattr(jnext, f))))
        d["v"].append(abs(float(tu[0]) - float(ju[0])))
        d["e_y"].append(abs(t_e_y - float(jnext.e_y)))
        assert tmpc.current_control.shape == (2 * tmpc.N,)
        assert tmpc.current_prediction[0].shape == (tmpc.N + 1,)
    d = {f: np.array(v) for f, v in d.items()}
    ok_t, ok_j = np.array(ok_t), np.array(ok_j)
    # acceptance on every step (the JAX loop rejects 5 of the 40 at a
    # pinch point), e_y before the solve
    np.testing.assert_array_equal(ok_t, ok_j)
    both = ok_t & ok_j
    assert both.mean() >= 0.85
    assert d["e_y"].max() <= 1e-3
    # the next pose and progress: tests/test_torch_slice.py's bars
    for f in ("x", "y", "s"):
        df = d[f][both]
        assert (df <= 1e-3).mean() >= 0.95, (f, (df <= 1e-3).mean())
        assert np.median(df) <= 1e-4 and df.max() <= 1e-2, (f, df.max())
    # v and psi': that file's bands; its medians and shares (2e-4, >= 85 /
    # 90 % within 1e-3) do not hold here even between the JAX package's own
    # TPU entry and XLA solver (tools/api_solver_spread.py: v median
    # 1.214e-3, 42.9 % within 1e-3), so the medians are held at 2e-3 / 5e-4
    for f, med, band in (("v", 2e-3, 1e-1), ("psi", 5e-4, 5e-2)):
        df = d[f][both]
        assert np.median(df) <= med and df.max() <= band, (f, df.max())
    # the lap advanced: the JAX loop's progress over the 40 steps
    assert float(api["outs"][-1][1].s) > 1.0


def test_api_and_viz_import_no_jax():
    code = ("import sys, multi_purpose_mpc_tpu_torch.api, "
            "multi_purpose_mpc_tpu_torch.utils.viz; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'multi_purpose_mpc_tpu', 'matplotlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
