"""Port parity, setup layer: config, map, path, speed profile, segments,
vehicle model, Monte-Carlo starts — the PyTorch port
(multi_purpose_mpc_tpu_torch) against the JAX package on the same inputs.

Both run on the CPU.  Shared fixtures and helpers here are imported by the
other tests/test_torch_*.py files.
"""

import dataclasses
import functools
import inspect
import math
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multi_purpose_mpc_tpu.config as jcfg
from multi_purpose_mpc_tpu.models import bicycle as jbike
from multi_purpose_mpc_tpu.ops import admm as jadmm
from multi_purpose_mpc_tpu.ops import grid as jgrid
from multi_purpose_mpc_tpu.ops.constraints import extract_all_segments as jextract
from multi_purpose_mpc_tpu.ops.path import build_reference_path as jbuild_path
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile as jspeed
from multi_purpose_mpc_tpu.simulation import feasible_starts as jfeasible
from multi_purpose_mpc_tpu.utils import maps as jmaps

import multi_purpose_mpc_tpu_torch.config as tcfg
from multi_purpose_mpc_tpu_torch import interop, simulation as tsim
from multi_purpose_mpc_tpu_torch.models import bicycle as tbike
from multi_purpose_mpc_tpu_torch.ops import admm as tadmm
from multi_purpose_mpc_tpu_torch.ops import grid as tgrid
from multi_purpose_mpc_tpu_torch.ops.constraints import extract_all_segments
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.utils import maps as tmaps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "maps")


def jax_scenario():
    """Sim_Track through the JAX package: grid with obstacles, path with
    speed profile, static segments, configs.  Built once per process; each
    caller gets its own dict."""
    return dict(_jax_scenario())


@functools.lru_cache(maxsize=1)
def _jax_scenario():
    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        jcfg.sim_track_preset(asset_dir=ASSETS))
    grid = jmaps.load_grid_map(map_cfg)
    path = jbuild_path(grid, path_cfg)
    grid = jmaps.add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                                    obstacles)
    path = jspeed(path, speed_cfg)
    segs = jextract(grid, path, 2.0 * model_cfg.safety_margin,
                    n_samples=mpc_cfg.n_scan_samples,
                    max_segments=mpc_cfg.max_segments)
    return dict(grid=grid, path=path, segs=segs, map_cfg=map_cfg,
                path_cfg=path_cfg, model_cfg=model_cfg, mpc_cfg=mpc_cfg,
                speed_cfg=speed_cfg, obstacles=obstacles)


def port_configs(**mpc_overrides):
    """The port's Sim_Track configs ``(model_cfg, mpc_cfg)``."""
    _, _, model_cfg, mpc_cfg, _, _ = tcfg.sim_track_preset(asset_dir=ASSETS)
    return model_cfg, dataclasses.replace(mpc_cfg, **mpc_overrides)


@pytest.fixture(scope="module")
def jsc():
    return jax_scenario()


@pytest.fixture(scope="module")
def port_setup():
    """Sim_Track built through the port alone."""
    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        tcfg.sim_track_preset(asset_dir=ASSETS))
    grid = tmaps.load_grid_map(map_cfg, device="cpu")
    path = build_reference_path(grid, path_cfg)
    grid = tmaps.add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                                    obstacles)
    return dict(grid=grid, path=path,
                vpath=compute_speed_profile(path, speed_cfg))


def test_port_never_imports_jax():
    code = ("import sys, multi_purpose_mpc_tpu_torch, "
            "multi_purpose_mpc_tpu_torch.simulation, "
            "multi_purpose_mpc_tpu_torch.ops.corridor_extract, "
            "multi_purpose_mpc_tpu_torch.ops.admm_cuda, "
            "multi_purpose_mpc_tpu_torch.ops.cyclic_reduction, "
            "multi_purpose_mpc_tpu_torch.ops.lidar, "
            "multi_purpose_mpc_tpu_torch.ops.mapping, "
            "multi_purpose_mpc_tpu_torch.interop, "
            "multi_purpose_mpc_tpu_torch.parallel.fleet, "
            "multi_purpose_mpc_tpu_torch.parallel.mesh, "
            "multi_purpose_mpc_tpu_torch.utils.checkpoint, "
            "multi_purpose_mpc_tpu_torch.utils.profiling, chip_smoke, "
            "tests.torch_dist_worker, "
            "tools.oracle_lap, tools.k2_compare, tools.k2_parts; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'multi_purpose_mpc_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# fields the port leaves out on purpose (TPU-only code paths; see its config)
_LEFT_OUT = {"SolverConfig": {"kernel_lanes", "rolled_stage_loops"},
             "MPCConfig": {"solver_backend", "extract_backend"}}


@pytest.mark.parametrize("name", ["MapConfig", "PathConfig", "ModelConfig",
                                  "SolverConfig", "MPCConfig",
                                  "SpeedProfileConstraints", "SimConfig",
                                  "LidarConfig"])
def test_config_defaults_match(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf = {f.name: f for f in dataclasses.fields(jc)}
    tf = {f.name: f for f in dataclasses.fields(tc)}
    assert set(jf) - set(tf) == _LEFT_OUT.get(name, set())
    assert set(tf) <= set(jf)
    for k, f in tf.items():
        if f.default is not dataclasses.MISSING and k != "solver":
            assert f.default == jf[k].default, k
    if name == "MPCConfig":
        j, t = jcfg.MPCConfig(), tcfg.MPCConfig()
        _assert_shared_fields_equal(j, t)
        assert t.kappa_max(0.12) == j.kappa_max(0.12)
    if name == "LidarConfig":
        kw = dict(FoV=270, range=1.0, resolution=3, n_ray_samples=256)
        j, t = jcfg.LidarConfig(**kw), tcfg.LidarConfig(**kw)
        _assert_shared_fields_equal(j, t)
        assert t.n_beams == j.n_beams == 91
        assert tcfg.LidarConfig.for_grid(
            tgrid.make_grid_map(np.ones((2, 2)), (0.0, 0.0), 0.005,
                                device="cpu"), **kw).grid_resolution \
            == float(np.float32(0.005))


def _assert_shared_fields_equal(a, b):
    """Every field of the port's config ``b`` equals the JAX one in ``a``,
    nested configs included."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            _assert_shared_fields_equal(va, vb)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("preset", ["sim_track_preset", "real_track_preset"])
def test_presets_match(preset):
    j = getattr(jcfg, preset)(asset_dir=ASSETS)
    t = getattr(tcfg, preset)(asset_dir=ASSETS)
    for a, b in zip(j, t):
        if dataclasses.is_dataclass(a):
            _assert_shared_fields_equal(a, b)
        else:
            assert tuple(a) == tuple(b)
    jm, tm = j[2], t[2]
    assert jm.safety_margin == tm.safety_margin


def test_entry_points_default_to_the_card():
    """The entry points a user calls first run on the card unless the
    caller names another device (read from the signatures: nothing is
    allocated)."""
    from multi_purpose_mpc_tpu_torch.mpc import weights_from_config
    from multi_purpose_mpc_tpu_torch.ops.ltv_qp import init_solver_carry

    for fn in (tmaps.load_grid_map, tgrid.make_grid_map, weights_from_config,
               init_solver_carry):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__name__
    # the JAX carry-across helpers stay on the CPU (they feed CPU tests)
    assert inspect.signature(interop.grid_map).parameters[
        "device"].default == "cpu"


def test_budget_warning_matches():
    """The budget-as-regularizer warning fires exactly where the JAX
    package's does."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tcfg.MPCConfig()
        tcfg.MPCConfig(R=(0.5, 0.01),
                       solver=tcfg.SolverConfig(iterations=200, rho_updates=10))
    with pytest.warns(UserWarning, match="implicit regularizer"):
        tcfg.MPCConfig(solver=tcfg.SolverConfig(iterations=200, rho_updates=10))
    with pytest.warns(UserWarning, match="implicit regularizer"):
        tcfg.MPCConfig(solver=tcfg.SolverConfig(escalate_lanes=64))


def test_grid_and_obstacle_raster_bitwise(jsc, port_setup):
    np.testing.assert_array_equal(port_setup["grid"].occ.numpy(),
                                  np.asarray(jsc["grid"].occ))
    # the float32 on-device obstacle path too (world -> pixel in float32)
    obs = np.asarray(jsc["obstacles"], np.float32)
    jg = jgrid.add_obstacles(jsc["grid"], obs[:, 0] + 0.013, obs[:, 1] - 0.021,
                             obs[:, 2] * 1.5)
    tg = tgrid.add_obstacles(interop.grid_map(jsc["grid"]),
                             obs[:, 0] + 0.013, obs[:, 1] - 0.021,
                             obs[:, 2] * 1.5)
    np.testing.assert_array_equal(tg.occ.numpy(), np.asarray(jg.occ))


def test_w2m_m2w_lookup_bitwise(jsc):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.2, 1.6, 4000).astype(np.float32)
    y = rng.uniform(-2.2, 0.6, 4000).astype(np.float32)
    jg, tg = jsc["grid"], interop.grid_map(jsc["grid"])
    jpx, jpy = jgrid.w2m(jg, jnp.asarray(x), jnp.asarray(y))
    tpx, tpy = tgrid.w2m(tg, torch.tensor(x), torch.tensor(y))
    np.testing.assert_array_equal(tpx.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(tpy.numpy(), np.asarray(jpy))
    np.testing.assert_array_equal(tgrid.lookup(tg, tpx, tpy).numpy(),
                                  np.asarray(jgrid.lookup(jg, jpx, jpy)))
    jwx, jwy = jgrid.m2w(jg, jpx, jpy)
    twx, twy = tgrid.m2w(tg, tpx, tpy)
    np.testing.assert_allclose(twx.numpy(), np.asarray(jwx), atol=1e-6)
    np.testing.assert_allclose(twy.numpy(), np.asarray(jwy), atol=1e-6)


def test_path_geometry(jsc, port_setup):
    jp, tp = jsc["path"], port_setup["path"]
    assert tp.n_wp == jp.n_wp == 200 and tp.circular == jp.circular
    for f in ("x", "y", "psi", "kappa", "seg_len", "cum_len", "seg_dist",
              "length", "ub", "lb"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), atol=1e-5,
                                   err_msg=f)
    # static border points are first-occupied cell centres: float32 trig
    # noise can move a ray's target across a cell edge, so they agree to
    # within one grid cell (and the widths above to 1e-5)
    cell = float(jsc["map_cfg"].resolution)
    for f in ("border_ub", "border_lb"):
        d = np.abs(getattr(tp, f).numpy() - np.asarray(getattr(jp, f)))
        assert d.max() <= cell + 1e-6, (f, d.max())


def test_speed_profile(jsc):
    # same path in (carried across), speed profile solved by each package
    tp = interop.path_data(jsc["path"])
    tv = compute_speed_profile(tp, tcfg.SpeedProfileConstraints()).v_ref
    # fixed-iteration float32 ADMM: op order moves the result by < 1e-3
    np.testing.assert_allclose(tv.numpy(), np.asarray(jsc["path"].v_ref),
                               atol=1e-3)
    assert float(tv.min()) > 0.0


def test_dense_admm_matches(rng):
    n, m = 12, 20
    M = rng.normal(size=(n, n))
    P = (M @ M.T + np.eye(n)).astype(np.float32)
    q = rng.normal(size=n).astype(np.float32)
    A = rng.normal(size=(m, n)).astype(np.float32)
    l = (-rng.uniform(0.5, 1.5, m)).astype(np.float32)
    u = rng.uniform(0.5, 1.5, m).astype(np.float32)
    cfg_j = jcfg.SolverConfig(iterations=50, rho_updates=4)
    cfg_t = tcfg.SolverConfig(iterations=50, rho_updates=4)
    rj = jadmm.admm_solve(*(jnp.asarray(a) for a in (P, q, A, l, u)), cfg_j)
    rt = tadmm.admm_solve(*(torch.tensor(a) for a in (P, q, A, l, u)), cfg_t)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-4)
    assert int(rt.status) == int(rj.status)
    np.testing.assert_allclose(float(rt.r_prim), float(rj.r_prim), atol=1e-4)


def test_segments_match(jsc):
    """Free segments on the same grid and path: valid flags equal,
    endpoints within 1e-5."""
    sm = jsc["model_cfg"].safety_margin
    cfg = jsc["mpc_cfg"]
    ts = extract_all_segments(interop.grid_map(jsc["grid"]),
                              interop.path_data(jsc["path"]), 2.0 * sm,
                              cfg.n_scan_samples, cfg.max_segments)
    js = jsc["segs"]
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_allclose(ts.ub_xy.numpy(), np.asarray(js.ub_xy), atol=1e-5)
    np.testing.assert_allclose(ts.lb_xy.numpy(), np.asarray(js.lb_xy), atol=1e-5)
    assert ts.valid.sum(-1).max() >= 2  # obstacles split some scanlines


def test_vehicle_model_matches(jsc):
    jp = jsc["path"]
    tp = interop.path_data(jp)
    rng = np.random.default_rng(7)
    B = 64
    wp = rng.integers(0, tp.n_wp, B).astype(np.int32)
    ey = rng.uniform(-0.05, 0.05, B).astype(np.float32)
    ep = rng.uniform(-0.3, 0.3, B).astype(np.float32)
    s = rng.uniform(-0.5, 9.5, B).astype(np.float32)

    jst = jax.vmap(lambda w, e, p: jbike.init_car_state(jp, 30, e, p, w))(
        jnp.asarray(wp), jnp.asarray(ey), jnp.asarray(ep))
    tst = tbike.init_car_state(tp, 30, torch.tensor(ey), torch.tensor(ep),
                               torch.tensor(wp))
    ref = interop.car_state(jst)
    for f in ("x", "y", "psi", "s", "u_seq"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   getattr(ref, f).numpy(), atol=1e-6,
                                   err_msg=f)

    loc_j = jax.vmap(lambda v: jbike.locate_waypoint(jp, v))(jnp.asarray(s))
    np.testing.assert_array_equal(
        tbike.locate_waypoint(tp, torch.tensor(s)).numpy(), np.asarray(loc_j))

    w = torch.tensor(wp)
    e_y_t, e_psi_t = tbike.t2s(tp, w, tst.x, tst.y, tst.psi)
    np.testing.assert_allclose(e_y_t.numpy(), ey, atol=1e-6)
    np.testing.assert_allclose(e_psi_t.numpy(), ep, atol=1e-6)

    v = torch.tensor(rng.uniform(0.0, 1.0, B).astype(np.float32))
    d = torch.tensor(rng.uniform(-0.5, 0.5, B).astype(np.float32))
    tnew = tbike.drive(tst, tp, v, d, 0.12, 0.05)
    jnew = jax.vmap(lambda st, vv, dd: jbike.drive(st, jp, vv, dd, 0.12, 0.05))(
        jst, jnp.asarray(v.numpy()), jnp.asarray(d.numpy()))
    for f in ("x", "y", "psi", "s"):
        np.testing.assert_allclose(getattr(tnew, f).numpy(),
                                   np.asarray(getattr(jnew, f)), atol=1e-6)

    vr = rng.uniform(0.3, 1.0, (B, 30)).astype(np.float32)
    kr = rng.uniform(-3, 3, (B, 30)).astype(np.float32)
    dsr = rng.uniform(0.03, 0.06, (B, 30)).astype(np.float32)
    for a, b in zip(tbike.linearize(*(torch.tensor(x) for x in (vr, kr, dsr))),
                    jbike.linearize(vr, kr, dsr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_feasible_starts_identical(jsc):
    """One numpy seed gives both packages the same Monte-Carlo starts."""
    model_cfg, mpc_cfg = port_configs()
    wj, ej = jfeasible(jsc["grid"], jsc["path"], jsc["mpc_cfg"],
                       jsc["model_cfg"], 96, np.random.default_rng(21))
    wt, et = tsim.feasible_starts(interop.grid_map(jsc["grid"]),
                                  interop.path_data(jsc["path"]), mpc_cfg,
                                  model_cfg, 96, np.random.default_rng(21))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-7)
    assert wt.dtype == torch.int32 and et.dtype == torch.float32


def test_port_setup_alone_reaches_the_same_scenario(port_setup):
    """The port's own setup (no JAX input) gives the known-good Sim_Track
    numbers: 200 waypoints, ~8.72 m, a positive speed profile."""
    p = port_setup["vpath"]
    assert p.n_wp == 200
    assert math.isclose(float(p.length), 8.72, abs_tol=0.01)
    assert 0.0 < float(p.v_ref.min()) and float(p.v_ref.max()) <= 1.0 + 1e-3
