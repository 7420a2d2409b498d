"""The port's graph-ready rollout (``simulation._rollout``) on the CPU.

On the card every rollout is captured as CUDA graphs and replayed; the
same form (two static buffer sets for the carry, (T, B) logs written at a
device-side step counter) runs eagerly here.  It must give exactly what
the list-and-stack loop of earlier revisions gave, which this file keeps
as its reference (:func:`_stacked`): bitwise, on the static, dynamic,
sweep and LiDAR (scatter) paths, at B = 4 lanes for 3 steps.  The launch
accounting of a replayed graph is checked with fake counters, and a
3-step ``simulate_fleet`` is held to tests/test_torch_slice.py's bars
against the JAX package's ``simulate_fleet``.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.config import SimConfig as JSimConfig
from multi_purpose_mpc_tpu.simulation import (feasible_starts as jfeasible,
                                              init_fleet as jinit_fleet,
                                              simulate_fleet as jsimulate_fleet)

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import LidarConfig, SimConfig
from multi_purpose_mpc_tpu_torch.mpc import WeightSet, mpc_step_batched
from multi_purpose_mpc_tpu_torch.ops.corridor_extract import build_scanline_table
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (build_horizon_table,
                                                           empty_segments)
from multi_purpose_mpc_tpu_torch.ops.lidar import scan_fleet, scatter_writeback_
from multi_purpose_mpc_tpu_torch.utils import graphs, kernels
from multi_purpose_mpc_tpu_torch.utils.tree import leaves
from tests.test_torch_setup import jax_scenario, port_configs

B, T = 4, 3
LIDAR = dict(FoV=360, range=1.0, resolution=4, n_ray_samples=192)


@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    tmodel, tcfg = port_configs()
    tpath = interop.path_data(s["path"])
    wp, ey = jfeasible(s["grid"], s["path"], s["mpc_cfg"], s["model_cfg"], B,
                       np.random.default_rng(5))
    s.update(tpath=tpath, tgrid=interop.grid_map(s["grid"]),
             tsegs=interop.segment_candidates(s["segs"]), tmodel=tmodel,
             tcfg=tcfg, wp=wp, ey=ey,
             state0=interop.car_state(jinit_fleet(s["path"], tcfg.N, B,
                                                  e_y0=ey, wp_id0=wp)))
    return s


def _stacked(step, state0, steps):
    """The list-and-stack loop: ``steps`` applications of ``step: state ->
    (state, log)``, the logs stacked at the end."""
    state, logs = state0, []
    for _ in range(steps):
        state, log = step(state)
        logs.append(log)
    stacked = [torch.stack(f) for f in zip(*logs)]
    if hasattr(logs[0], "_fields"):
        return state, type(logs[0])(*stacked)
    return state, tuple(stacked)


def _assert_bitwise(got, want):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b) or (
            a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a[~a.isnan()], b[~b.isnan()])), i


def _dynamic_base(sc):
    return build_horizon_table(sc["tpath"], empty_segments(
        sc["tpath"].n_wp, sc["tcfg"].max_segments, "cpu"), sc["tcfg"])


@pytest.mark.parametrize("path", ["static", "dynamic", "sweep"])
def test_rollout_bitwise_vs_stacked_loop(sc, path):
    tcfg, tmodel, tpath = sc["tcfg"], sc["tmodel"], sc["tpath"]
    kw = {}
    if path == "sweep":
        rows = torch.tensor([[1.0, 0.0, 0.0, 0.5, 0.01, 1.0, 0.0, 0.0],
                             [0.0, 0.0, 0.0, 0.01, 0.01, 0.0, 0.0, 100.0]])
        rows = rows[torch.arange(B) % 2]
        kw["weights"] = WeightSet(Q=rows[:, :3].contiguous(),
                                  R=rows[:, 3:5].contiguous(),
                                  QN=rows[:, 5:].contiguous())
    if path == "dynamic":
        scan = build_scanline_table(sc["tgrid"], tpath, tcfg.n_scan_samples)
        base = _dynamic_base(sc)
        step = lambda st: tsim._sim_step_batched_gridded(
            st, tpath, sc["tgrid"].occ, tcfg, tmodel, scan, base, None)
        sim, table = SimConfig(max_steps=T, static_grid=False), scan
    else:
        table = build_horizon_table(tpath, sc["tsegs"], tcfg)
        step = lambda st: tsim._post_control(
            mpc_step_batched(st, tpath, tcfg, tmodel, table, **kw), tpath,
            tmodel)
        sim = SimConfig(max_steps=T)
    want = _stacked(step, sc["state0"], T)
    res = tsim.simulate_fleet(sc["tgrid"], tpath, tcfg, tmodel, sim,
                              sc["state0"], table=table, **kw)
    _assert_bitwise((res.final_state, res.log), want)
    assert res.log.x.shape == (T, B)


def test_lidar_scatter_rollout_bitwise_vs_stacked_loop(sc):
    """The LiDAR fleet's carry holds the maps too: per-lane maps from an
    all-free known grid, written in place by the scatter write-back."""
    tcfg, tmodel, tpath = sc["tcfg"], sc["tmodel"], sc["tpath"]
    known = dataclasses.replace(sc["tgrid"],
                                occ=torch.ones_like(sc["tgrid"].occ))
    lidar = LidarConfig(**LIDAR)
    scan = build_scanline_table(known, tpath, tcfg.n_scan_samples)
    base = _dynamic_base(sc)
    occ = known.occ.expand(B, -1, -1).clone()

    def step(st):
        scans = scan_fleet(sc["tgrid"], st.x, st.y, st.psi, lidar,
                           backend="march", wp_id=st.wp_id)
        scatter_writeback_(known, occ, st.x, st.y, st.psi, scans)
        return tsim._sim_step_batched_gridded(st, tpath, occ, tcfg, tmodel,
                                              scan, base, None)

    want = _stacked(step, sc["state0"], T)
    res, got_occ = tsim.simulate_lidar_fleet(
        sc["tgrid"], known, tpath, tcfg, tmodel,
        SimConfig(max_steps=T, static_grid=False), lidar, sc["state0"],
        table=scan)
    _assert_bitwise((res.final_state, res.log), want)
    assert torch.equal(got_occ, occ)
    assert bool((got_occ == 0).any())  # the scans found obstacles


def test_copy_back_survives_aliased_leaves():
    """A step whose new leaves are old leaves, swapped, transposed views of
    them, or written into the ``dst`` buffer itself: the double-buffered
    carry reads every old value before anything overwrites it."""
    rng = np.random.default_rng(0)
    carry0 = tuple(torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
                   for s in ((3, 3), (3, 3), (3,)))

    def new_carry(carry):
        x, y, z = carry
        return (y.t(), x, z + x[0]), (x.sum(1), (y[:, 0] > 0))

    def step(carry, dst, _):
        x, y, z = carry
        (nx, ny, _), log = new_carry(carry)
        return (nx, ny, torch.add(z, x[0], out=dst[2])), log

    want = _stacked(new_carry, carry0, 5)
    got = tsim._rollout(step, carry0, 5)
    _assert_bitwise(got, want)
    with pytest.raises(ValueError, match="shapes and dtypes"):
        tsim._rollout(lambda c, _, __: ((c[0], c[1], c[2].double()),
                                        (c[2],)), carry0, 2)


@pytest.fixture
def fake_counters(monkeypatch):
    fns = {n: types.SimpleNamespace(launches=0) for n in ("k1", "k2", "k3")}
    monkeypatch.setattr(kernels, "launch_counters", lambda: {
        n: (f, "launches") for n, f in fns.items()})
    return fns


def test_replays_count_the_captured_launches(fake_counters):
    """The warm-up is a real step and its launches stay; the capture's are
    taken back; every replay adds what the capture counted."""
    f = fake_counters
    f["k3"].launches = 7

    def launch(**n):
        for k, v in n.items():
            f[k].launches += v

    launch(k1=1, k2=2)  # the warm-up: the first step, run eagerly
    delta = graphs.captured_launches(lambda: launch(k1=1, k2=2))
    assert delta == {"k1": 1, "k2": 2}
    assert kernels.launch_counts() == {"k1": 1, "k2": 2, "k3": 7}
    g = object.__new__(graphs.StepGraph)
    g.graph, g.launches = types.SimpleNamespace(replay=lambda: None), delta
    for _ in range(49):
        g.replay()
    assert kernels.launch_counts() == {"k1": 50, "k2": 100, "k3": 7}


class _EagerGraph:
    """Stands in for :class:`graphs.StepGraph` on the CPU: the warm-up runs
    (its result is ``first``) and every replay calls the step again."""

    def __init__(self, fn, warmup=None, pool=None):
        self.fn, self.first = fn, warmup() if warmup is not None else None
        _EagerGraph.made += 1

    def pool(self):
        return None

    def replay(self):
        self.out = self.fn()


def test_get_control_recaptures_when_its_inputs_are_replaced(monkeypatch):
    """``MPC.get_control`` captures again when the path (a new speed
    profile), the controller's config or the model's config is replaced,
    and only replays when the map's occupancy changes; ``drive`` captures
    again when the path is replaced; each step's control and prediction
    equal the eager loop's bit for bit."""
    from multi_purpose_mpc_tpu_torch import api as tapi
    from tests.test_torch_api import OBSTACLES, SPEED, _controller, _map

    def loop():
        m, rp = _map(tapi, device="cpu")
        car, ctrl = _controller(tapi, rp)
        made = []

        def step():
            u = ctrl.get_control()
            car.drive(u)
            made.append(_EagerGraph.made)
            return np.concatenate([u, *ctrl.current_prediction])

        out = [step()]
        m.add_obstacles([tapi.Obstacle(*OBSTACLES[0][:2], 0.05)])
        out.append(step())
        rp.compute_speed_profile(dict(SPEED, v_max=0.6))
        out.append(step())
        ctrl.config = dataclasses.replace(ctrl.config)
        car._model_cfg = dataclasses.replace(car._model_cfg)
        out.append(step())
        return np.stack(out), made

    _EagerGraph.made = 0
    eager, _ = loop()
    monkeypatch.setattr(graphs, "should_capture", lambda *a, **k: True)
    monkeypatch.setattr(graphs, "StepGraph", _EagerGraph)
    graphed, made = loop()
    # graphs made so far: get_control's 1, 1, 2, 3 and drive's 1, 1, 2, 2
    assert made == [2, 2, 4, 5]
    np.testing.assert_array_equal(graphed, eager)


def test_capture_rule_on_the_cpu():
    assert not graphs.should_capture("cpu")
    with graphs.disable_capture():
        assert not graphs.should_capture("cuda")
    assert graphs.should_capture("cuda")


def test_three_steps_vs_jax_simulate_fleet(sc):
    """A 3-step ``simulate_fleet`` through the graph-ready form against the
    JAX package's compiled ``simulate_fleet`` from the same starts, at
    tests/test_torch_slice.py's bars (strictly convex weights; both sides
    resume the carried rho, as the fused solve does)."""
    over = dict(R=(0.5, 0.01))
    tmodel, tcfg = port_configs(**over)
    tcfg = dataclasses.replace(
        tcfg, solver=dataclasses.replace(tcfg.solver, carry_rho=True))
    jcfg = dataclasses.replace(sc["mpc_cfg"], **over)
    jcfg = dataclasses.replace(
        jcfg, solver=dataclasses.replace(jcfg.solver, carry_rho=True))
    jst = jinit_fleet(sc["path"], jcfg.N, B, e_y0=sc["ey"], wp_id0=sc["wp"])
    jres = jsimulate_fleet(sc["grid"], sc["path"], jcfg, sc["model_cfg"],
                           JSimConfig(max_steps=T), jst)
    res = tsim.simulate_fleet(sc["tgrid"], sc["tpath"], tcfg, tmodel,
                              SimConfig(max_steps=T), interop.car_state(jst))
    jlog = jax.tree.map(np.asarray, jres.log)
    ok_t, ok_j = res.log.ok.numpy(), jlog.ok
    assert (ok_t == ok_j).mean() >= 0.95 and (ok_t & ok_j).mean() > 0.9
    both = ok_t & ok_j
    d = {f: np.abs(getattr(res.log, f).numpy() - getattr(jlog, f))
         for f in ("x", "y", "psi", "v", "s", "e_y")}
    assert d["e_y"].max() <= 1e-3
    for f in ("x", "y", "s"):
        df = d[f][both]
        assert (df <= 1e-3).mean() >= 0.95, (f, df)
        assert np.median(df) <= 1e-4 and df.max() <= 1e-2, (f, df.max())
    for f, frac, band in (("v", 0.85, 1e-1), ("psi", 0.90, 5e-2)):
        df = d[f][both]
        assert (df <= 1e-3).mean() >= frac, (f, df)
        assert np.median(df) <= 2e-4 and df.max() <= band, (f, df.max())
