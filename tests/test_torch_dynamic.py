"""Port parity, the dynamic-grid fleet: the scanline table, kernel K4's
plain version (``extract_occ_gather``), the memory-bounded
``segments_from_samples``, kernel K8's plain route
(``horizon_segments_from_table``), ``fleet_dynamic_segments`` and the
dynamic rollout, against the JAX package on the CPU and against the
float64 oracle.

Everything but the rollouts is integer reads and float32 copies of the same
data, so the bar is bitwise.  The per-step rollout bars are those of
tests/test_torch_slice.py (its module docstring gives the measurements
behind them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.ops.corridor_extract import (
    build_scanline_table as jbuild_scan, extract_occ_gather as jgather,
    extract_occ_pallas as jpallas, fleet_dynamic_segments as jfleet_segs,
    horizon_tables as jhorizon_tables)
from multi_purpose_mpc_tpu.ops import constraints as jcons
from multi_purpose_mpc_tpu.ops.path import gather_waypoint_index as jgwi
from multi_purpose_mpc_tpu.simulation import (
    _sim_step_batched_gridded as jstep_gridded, feasible_starts as jfeasible,
    init_fleet as jinit_fleet)

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import SimConfig
from multi_purpose_mpc_tpu_torch.ops import constraints as tcons
from multi_purpose_mpc_tpu_torch.ops import corridor_extract as tce
from multi_purpose_mpc_tpu_torch.ops.constraints import (SegmentCandidates,
                                                         segments_from_samples)
from multi_purpose_mpc_tpu_torch.ops.grid import make_grid_map
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
    build_horizon_table, empty_segments, horizon_block_from_segments)
from multi_purpose_mpc_tpu_torch.ops.corridor_cuda import corridor_select
from tests.oracle.corridor import free_segments_oracle, select_corridor_oracle
from tests import free_runs_cases
from tests.test_torch_setup import jax_scenario, port_configs

B4 = 4


@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    cfg = s["mpc_cfg"]
    jscan = jbuild_scan(s["grid"], s["path"], cfg.n_scan_samples)
    rng = np.random.default_rng(0)
    wp = jnp.asarray(rng.integers(0, s["path"].n_wp, B4), jnp.int32)
    idx = jax.vmap(lambda w: jgwi(s["path"], w + 1, jnp.arange(cfg.N)))(wp)
    # per-lane grids salted with random extra obstacle cells
    occ_b = np.broadcast_to(np.asarray(s["grid"].occ),
                            (B4,) + s["grid"].occ.shape).copy()
    for b in range(B4):
        occ_b[b, rng.integers(0, 500, 30), rng.integers(0, 500, 30)] = 0.0
    s.update(tpath=interop.path_data(s["path"]),
             tgrid=interop.grid_map(s["grid"]), jscan=jscan,
             tscan=interop.scanline_table(jscan), idx=np.asarray(idx),
             occ_b=occ_b)
    return s


def test_scanline_table_bitwise(sc):
    """The port's table from the same grid and (carried-across) path equals
    the JAX table field for field."""
    t = tce.build_scanline_table(sc["tgrid"], sc["tpath"],
                                 sc["mpc_cfg"].n_scan_samples)
    for f in tce.ScanlineTable._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(sc["jscan"], f)),
                                      err_msg=f)
    assert t.px.dtype == t.py.dtype == torch.int32
    assert bool(t.inb.any())


@pytest.mark.parametrize("grids", ["shared", "per_lane"])
def test_k4_plain_bitwise_vs_jax_gather_and_pallas(sc, grids):
    """K4's plain version against the JAX semantic reference and against
    the TPU kernel in interpret mode, B = 4, on the Sim_Track grid shared
    by all lanes and on per-lane grids with extra obstacle cells."""
    occ = np.asarray(sc["grid"].occ) if grids == "shared" else sc["occ_b"]
    px, py, _, _, _, row0 = jhorizon_tables(sc["jscan"], jnp.asarray(sc["idx"]))
    ref = np.asarray(jgather(jnp.asarray(occ), px, py))
    kern = np.asarray(jpallas(jnp.asarray(occ), px, py, row0,
                              sc["jscan"].window_rows, interpret=True))
    h = tce.horizon_tables(sc["tscan"], torch.tensor(sc["idx"]))
    out = tce.extract_occ(torch.tensor(occ), h.px, h.py)
    assert out.shape == (B4, sc["mpc_cfg"].N, sc["mpc_cfg"].n_scan_samples)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), kern)
    assert 0 < out.mean() < 1


def _segments_onehot(occ, cx, cy, min_width, max_segments):
    """segments_from_samples as it was before its memory was bounded (the
    JAX package's one-hot formulation, O(K^2) per scanline): the reference
    the scatter/gather version is held to bitwise."""
    free = occ > 0.5
    K = occ.shape[-1]
    no = torch.zeros(free.shape[:-1] + (1,), dtype=torch.bool)
    starts = free & ~torch.cat([no, free[..., :-1]], -1)
    ends = free & ~torch.cat([free[..., 1:], no], -1)
    raw = K // 2 + 1
    rs = torch.cumsum(starts.to(torch.int32), -1)
    re_ = torch.cumsum(ends.to(torch.int32), -1)
    r_iota = torch.arange(1, raw + 1, dtype=torch.int32)[:, None]
    k_iota = torch.arange(K, dtype=torch.int32)
    start_idx = ((starts[..., None, :] & (rs[..., None, :] == r_iota))
                 * k_iota).sum(-1)
    end_idx = ((ends[..., None, :] & (re_[..., None, :] == r_iota))
               * k_iota).sum(-1)
    valid = r_iota[:, 0] <= rs[..., -1:]
    ub_i = torch.clamp(start_idx - 1, min=0).long()
    lb_i = torch.clamp(end_idx + 1, max=K - 1).long()
    ubx, uby = torch.gather(cx, -1, ub_i), torch.gather(cy, -1, ub_i)
    lbx, lby = torch.gather(cx, -1, lb_i), torch.gather(cy, -1, lb_i)
    valid = valid & (torch.hypot(ubx - lbx, uby - lby) > min_width)
    pos = torch.cumsum(valid.to(torch.int32), -1) - 1
    s_iota = torch.arange(max_segments, dtype=torch.int32)[:, None]
    cOH = valid[..., None, :] & (pos[..., None, :] == s_iota)
    pick = lambda v: (cOH.to(occ.dtype) * v[..., None, :]).sum(-1)
    return SegmentCandidates(torch.stack([pick(ubx), pick(uby)], -1),
                             torch.stack([pick(lbx), pick(lby)], -1),
                             cOH.any(-1))


@pytest.mark.parametrize("free_frac", [0.1, 0.5, 0.9])
def test_segments_bounded_memory_bitwise_vs_onehot(free_frac):
    """Random 0/1 rows: the run-indexed segments equal the one-hot ones
    bit for bit, including rows with more runs than segment slots."""
    rng = np.random.default_rng(int(free_frac * 10))
    shape = (16, 30, 128)
    occ = torch.tensor((rng.random(shape) < free_frac).astype(np.float32))
    cx = torch.tensor(rng.normal(size=shape).astype(np.float32))
    cy = torch.tensor(rng.normal(size=shape).astype(np.float32))
    for min_width in (0.0, 0.5, 2.0):
        new = segments_from_samples(occ, cx, cy, min_width, 8)
        old = _segments_onehot(occ, cx, cy, min_width, 8)
        for a, b in zip(new, old):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
        assert new.valid.any()


@pytest.mark.parametrize("case,K,min_width", [
    ("patterns", 128, free_runs_cases.TIE_WIDTH), ("patterns", 128, 0.0),
    ("patterns", 40, free_runs_cases.TIE_WIDTH),
    ("patterns", 256, free_runs_cases.TIE_WIDTH),
    ("ties", 128, free_runs_cases.TIE_WIDTH), ("ties", 128, 0.04)])
def test_free_runs_plain_route_bitwise(case, K, min_width):
    """Kernel K8's plain route (``horizon_segments_from_table`` on CPU
    tensors) against ``horizon_segments`` on the gathered rows and against
    the one-hot formulation, bit for bit, on ``free_runs_cases``'
    scanlines: random, all free, all occupied, runs touching both ends,
    more runs than slots, out-of-bounds samples, and widths planted on
    ``min_width`` (exactly, an ulp off, and within an ulp or two; slots
    for every run there, so that each tie shows)."""
    S = 32 if case == "ties" else 8
    vals, table, idx = free_runs_cases.case(6, 30, K, seed=K,
                                            ties=case == "ties",
                                            min_width=min_width)
    out = tce.horizon_segments_from_table(vals, table, idx, min_width, S)
    h = tce.horizon_tables(table, idx)
    ref = tce.horizon_segments(vals, h, min_width, S)
    onehot = _segments_onehot(torch.where(h.inb, vals, torch.zeros_like(vals)),
                              h.cx, h.cy, min_width, S)
    for a, b, c in zip(out, ref, onehot):
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
        assert torch.equal(a, b) and torch.equal(a, c)
    kept = out.valid.sum(-1)
    assert out.valid.shape == (6, 30, S) and bool(out.valid.any())
    if case == "ties":  # the ties decide: some runs kept, some dropped
        runs = int((free_runs_cases.tie_row(K) > 0.5).sum()) // 2
        assert runs < S and 0 < int(kept.sum()) < runs * kept.numel()
    else:  # some scanlines fill every slot, some have none
        assert int(kept.max()) == S and int(kept.min()) == 0


@pytest.mark.parametrize("entry", ["fleet_dynamic_segments",
                                   "update_path_constraints"])
def test_dynamic_segments_through_k8_route_vs_jax(sc, entry, monkeypatch):
    """``fleet_dynamic_segments`` and ``update_path_constraints`` take the
    free runs through ``horizon_segments_from_table`` (once a call), and
    their segments stay bitwise the JAX package's (its gather extraction;
    its own ``free_segments`` for the one-lane corridor, whose corridor
    agrees within 1e-6: K2's twin selects by cross products)."""
    calls = []
    route = tce.horizon_segments_from_table

    def spy(*args):
        calls.append(route(*args))
        return calls[-1]

    monkeypatch.setattr(tce, "horizon_segments_from_table", spy)
    sm, cfg = sc["model_cfg"].safety_margin, sc["mpc_cfg"]
    if entry == "fleet_dynamic_segments":
        occ = sc["occ_b"]
        ref = jfleet_segs(jnp.asarray(occ), sc["jscan"], jnp.asarray(sc["idx"]),
                          2.0 * sm, cfg.max_segments, backend="gather")
        out = tce.fleet_dynamic_segments(torch.tensor(occ), sc["tscan"],
                                         torch.tensor(sc["idx"]), 2.0 * sm,
                                         cfg.max_segments)
        assert len(calls) == 1 and all(a is b for a, b in zip(out, calls[0]))
    else:
        wp, N = 57, cfg.N
        cor = tcons.update_path_constraints(sc["tgrid"], sc["tpath"], wp, N,
                                            2.0 * sm, sm)
        jcor = jcons.update_path_constraints(sc["grid"], sc["path"],
                                             jnp.int32(wp), N, 2.0 * sm, sm)
        for a, b in zip(cor, jcor):
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
        idx = jgwi(sc["path"], jnp.int32(wp), jnp.arange(N))
        ref = jax.vmap(lambda a, b: jcons.free_segments(
            sc["grid"], a, b, 2.0 * sm, cfg.n_scan_samples,
            cfg.max_segments))(sc["path"].border_ub[idx],
                               sc["path"].border_lb[idx])
        assert len(calls) == 1
        out = calls[0].index(0)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(out.valid.any())


@pytest.mark.parametrize("grids", ["shared", "per_lane"])
def test_fleet_dynamic_segments_bitwise(sc, grids):
    occ = np.asarray(sc["grid"].occ) if grids == "shared" else sc["occ_b"]
    sm, cfg = sc["model_cfg"].safety_margin, sc["mpc_cfg"]
    ref = jfleet_segs(jnp.asarray(occ), sc["jscan"], jnp.asarray(sc["idx"]),
                      2.0 * sm, cfg.max_segments, backend="gather")
    out = tce.fleet_dynamic_segments(torch.tensor(occ), sc["tscan"],
                                     torch.tensor(sc["idx"]), 2.0 * sm,
                                     cfg.max_segments)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _starts(sc, B, seed=3):
    wp, ey = jfeasible(sc["grid"], sc["path"], sc["mpc_cfg"], sc["model_cfg"],
                       B, np.random.default_rng(seed))
    return jinit_fleet(sc["path"], sc["mpc_cfg"].N, B, e_y0=ey, wp_id0=wp)


def test_dynamic_rollout_equals_static_bitwise(sc):
    """On an unchanged grid the dynamic rollout re-extracts exactly the
    static segments, so every log field equals the static rollout's."""
    tmodel, tcfg = port_configs()
    st0 = interop.car_state(_starts(sc, 8))
    kw = dict(grid=sc["tgrid"], path=sc["tpath"], cfg=tcfg, model=tmodel,
              state0=st0)
    static = tsim.simulate_fleet(sim=SimConfig(max_steps=5), **kw)
    dynamic = tsim.simulate_fleet(
        sim=SimConfig(max_steps=5, static_grid=False), table=sc["tscan"], **kw)
    for f in static.log._fields:
        assert torch.equal(getattr(static.log, f), getattr(dynamic.log, f)), f
    assert static.log.ok.float().mean() > 0.9


def test_dynamic_fleet_per_step_vs_jax(sc):
    """The port's dynamic-grid fleet step (K4 plain -> segments -> block ->
    K2 plain -> K1 plain) against the JAX dynamic-grid step (gather
    extraction, XLA selection and solve), from the JAX run's exact pre-step
    state each step: B = 8, 8 steps, strictly convex weights, the bars of
    tests/test_torch_slice.py."""
    B, T = 8, 8
    jcfg = dataclasses.replace(sc["mpc_cfg"], R=(0.5, 0.01))
    tmodel, tcfg = port_configs(R=(0.5, 0.01))
    base = build_horizon_table(sc["tpath"],
                               empty_segments(sc["tpath"].n_wp,
                                              tcfg.max_segments, "cpu"), tcfg)
    jstep = jax.jit(lambda st: jstep_gridded(
        st, sc["path"], sc["grid"], sc["grid"].occ, jcfg, sc["model_cfg"],
        sc["jscan"]))
    jst = _starts(sc, B)
    fields = ("x", "y", "psi", "v", "s", "e_y")
    d = {f: [] for f in fields}
    ok_t, ok_j, rp_t, rp_j = [], [], [], []
    for _ in range(T):
        pst = interop.car_state(jst)
        pst.solver.rho = torch.full_like(pst.solver.rho, tcfg.solver.rho)
        _, log = tsim._sim_step_batched_gridded(
            pst, sc["tpath"], sc["tgrid"].occ, tcfg, tmodel, sc["tscan"], base)
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
    tol = tcfg.feas_tol
    borderline = ((np.minimum(rp_t, rp_j) > 0.5 * tol)
                  & (np.maximum(rp_t, rp_j) < 2.0 * tol))
    assert ((ok_t == ok_j) | borderline).all()
    both = ok_t & ok_j
    assert both.mean() > 0.9
    assert d["e_y"].max() <= 1e-3
    for f in ("x", "y", "s"):
        df = d[f][both]
        assert (df <= 1e-3).mean() >= 0.95, (f, (df <= 1e-3).mean())
        assert np.median(df) <= 1e-4 and df.max() <= 1e-2, (f, df.max())
    for f, frac, band in (("v", 0.85, 1e-1), ("psi", 0.90, 5e-2)):
        df = d[f][both]
        assert (df <= 1e-3).mean() >= frac, (f, (df <= 1e-3).mean())
        assert np.median(df) <= 2e-4 and df.max() <= band, (f, df.max())


def test_dynamic_corridor_vs_float64_oracle(sc):
    """A disk obstacle dropped onto the track after setup: the port's
    dynamic corridor (extraction on the changed grid, segments, horizon
    block, selection) at a few waypoints against the float64 loop oracle,
    within one 5 mm grid cell."""
    tmodel, tcfg = port_configs()
    sm, K, S, N = (tmodel.safety_margin, tcfg.n_scan_samples,
                   tcfg.max_segments, tcfg.N)
    path = sc["tpath"]
    res = float(sc["grid"].resolution)
    origin = tuple(float(o) for o in np.asarray(sc["grid"].origin))
    occ = np.asarray(sc["grid"].occ).copy()
    # a 3 cm disk just left of the centre line at waypoint 60
    wx, wy = float(path.x[60]), float(path.y[60])
    psi = float(path.psi[60])
    cxo, cyo = wx - 0.03 * np.sin(psi), wy + 0.03 * np.cos(psi)
    yy, xx = np.mgrid[0:occ.shape[0], 0:occ.shape[1]]
    disk = ((xx + 0.5) * res + origin[0] - cxo) ** 2 \
        + ((yy + 0.5) * res + origin[1] - cyo) ** 2 <= 0.03 ** 2
    occ[disk] = 0.0
    grid = make_grid_map(occ, origin, res, device="cpu")

    wp = torch.tensor([50, 55, 58, 120], dtype=torch.int32)
    offs = torch.arange(N)
    idx = (wp.long()[:, None] + 1 + offs[None, :]) % path.n_wp
    segs = tce.fleet_dynamic_segments(grid.occ, sc["tscan"], idx, 2.0 * sm, S)
    base = build_horizon_table(path, empty_segments(path.n_wp, S, "cpu"),
                               tcfg)
    cor = corridor_select(horizon_block_from_segments(base, wp, segs), S, sm)
    assert (segs.valid.sum(-1) >= 2).any(), "the obstacle splits no scanline"

    f64 = lambda t: t.numpy().astype(np.float64)
    for b in range(wp.shape[0]):
        ix = idx[b].numpy()
        prev = np.concatenate([ix[:1], ix[:-1]])
        seg_list = [free_segments_oracle(occ, origin, res,
                                         f64(path.border_ub[i]),
                                         f64(path.border_lb[i]), 2 * sm, K, S)
                    for i in ix]
        oub, olb, _ = select_corridor_oracle(
            f64(path.x)[ix], f64(path.y)[ix], f64(path.psi)[ix],
            f64(path.seg_dist)[prev], f64(path.psi)[prev], seg_list, sm)
        np.testing.assert_allclose(cor.ub[b].numpy(), oub, atol=res)
        np.testing.assert_allclose(cor.lb[b].numpy(), olb, atol=res)
