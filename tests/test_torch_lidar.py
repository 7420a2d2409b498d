"""Port parity, the LiDAR sensor model: beam angles, the static cell tables,
the three scans (march, conservative, cells) and the map write-back, against
the JAX package on the CPU.

Tolerances and their reasons:

* Tables, hit pixels and map write-back are integer work on the same data:
  bitwise.
* Beam angles and sample fractions: within 1e-6 (4 float32 ulps of pi; 1 um
  at the end of a 1 m beam).  Both packages evaluate ``start * (1 - t) +
  stop * t``, but XLA:CPU folds ``stop * i / (n - 1)`` into ``i * c`` with
  a rounded constant c (an error growing with i) and contracts into an FMA;
  the port rounds each operation.
* Scans against the JAX package: the port takes cos/sin in float64 rounded
  once, XLA:CPU in float32 (the two differ in the last bit on ~1 % of
  angles), and XLA contracts products into FMAs.  So a beam can end one
  cell apart on a grazing hit: hit flags agree on >= 99.9 % of beams; where
  both scans hit, the hit cells are at most one cell apart (res * sqrt 2);
  where they hit the same cell, the ranges agree within 4.8e-7 m, two
  float32 ulps of the world coordinates (up to 2 m here) that XLA rounds
  through an FMA in ``m2w`` before taking the difference.
* Port ``cells`` against port ``scan(conservative=True)``: the bar the JAX
  package sets for its own pair (tests/test_scan_fleet.py).
* The LiDAR fleet step against the JAX package's, from the same state and
  maps: the maps bitwise where the scans agree, the logs at the bars of
  tests/test_torch_dynamic.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.config import LidarConfig as JLidarConfig
from multi_purpose_mpc_tpu.config import SimConfig as JSimConfig
from multi_purpose_mpc_tpu.config import real_track_preset as jreal_preset
from multi_purpose_mpc_tpu.ops.corridor_extract import (
    build_scanline_table as jbuild_scan)
from multi_purpose_mpc_tpu.ops import lidar as jl
from multi_purpose_mpc_tpu.ops.grid import lookup_world
from multi_purpose_mpc_tpu.ops.path import build_reference_path as jbuild_path
from multi_purpose_mpc_tpu.simulation import feasible_starts as jfeasible
from multi_purpose_mpc_tpu.simulation import init_fleet as jinit_fleet
from multi_purpose_mpc_tpu.simulation import simulate_lidar_fleet as jlidar_fleet
from multi_purpose_mpc_tpu.utils.maps import load_grid_map as jload

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import LidarConfig, SimConfig
from multi_purpose_mpc_tpu_torch.ops import lidar as tl
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap
from tests.test_torch_setup import ASSETS, jax_scenario, port_configs

LIDAR = dict(FoV=360, range=1.0, resolution=4, n_ray_samples=256)
LOOP = dict(FoV=360, range=1.0, resolution=4, n_ray_samples=192)  # bench.py's
B = 12


@pytest.fixture(scope="module")
def sc():
    """Sim_Track, the lidar configs and B = 12 poses near the path in free
    cells (the cells backend's precondition), as tests/test_scan_fleet.py
    draws them."""
    s = jax_scenario()
    grid, path = s["grid"], s["path"]
    rng = np.random.default_rng(3)
    xs, ys, ps = [], [], []
    while len(xs) < B:
        i = int(rng.integers(0, path.n_wp))
        x = float(np.asarray(path.x)[i] + rng.normal(0, 0.02))
        y = float(np.asarray(path.y)[i] + rng.normal(0, 0.02))
        if float(lookup_world(grid, x, y)) > 0.5:
            xs.append(x)
            ys.append(y)
            ps.append(float(rng.uniform(-np.pi, np.pi)))
    pose = [np.asarray(v, np.float32) for v in (xs, ys, ps)]
    s.update(tgrid=interop.grid_map(grid), tpath=interop.path_data(path),
             jcfg=JLidarConfig(**LIDAR), tcfg=LidarConfig(**LIDAR), pose=pose,
             jpose=[jnp.asarray(v) for v in pose],
             tpose=[torch.tensor(v) for v in pose])
    s["jcells"] = jl.occupied_cell_table(grid.occ)
    s["tcells"] = tl.occupied_cell_table(s["tgrid"].occ)
    s["twpc"] = tl.waypoint_cells(s["tcells"], s["tgrid"], s["tpath"],
                                  s["tcfg"].range)
    return s


def test_lidar_config_checks():
    cfg = LidarConfig(**LIDAR)
    assert cfg.n_beams == JLidarConfig(**LIDAR).n_beams == 91
    cfg.validate_for_grid(0.005)
    coarse = LidarConfig(FoV=360, range=5.0, resolution=4, n_ray_samples=64)
    with pytest.raises(ValueError, match="n_ray_samples"):
        coarse.validate_for_grid(0.005)
    with pytest.raises(ValueError, match="n_ray_samples"):
        LidarConfig(range=5.0, n_ray_samples=64, grid_resolution=0.005)


@pytest.mark.parametrize("fov,res,n", [(360, 4, 0), (180, 1, 0), (0, 0, 64)])
def test_beam_angles_and_linspace(fov, res, n):
    if n:  # the free-space sample fractions
        t = tl.linspace_f32(0.0, 0.95, n, "cpu").numpy()
        ref = np.asarray(jnp.linspace(0.0, 0.95, n))
    else:
        t = tl.beam_angles(LidarConfig(FoV=fov, resolution=res), "cpu").numpy()
        ref = np.asarray(jl.beam_angles(JLidarConfig(FoV=fov, resolution=res)))
    assert t.dtype == np.float32 and t.shape == ref.shape
    assert t[0] == ref[0] and t[-1] == ref[-1]
    assert np.abs(t - ref).max() <= 1e-6


def _real_track():
    map_cfg, path_cfg, *_ = jreal_preset(asset_dir=ASSETS)
    grid = jload(map_cfg)
    return grid, jbuild_path(grid, path_cfg)


@pytest.mark.parametrize("track", ["sim_track", "real_track"])
def test_cell_tables_bitwise(sc, track):
    """The boundary-cell table and the per-waypoint pruned table equal the
    JAX package's bit for bit; the slack agrees to float32."""
    if track == "sim_track":
        grid, path = sc["grid"], sc["path"]
    else:
        grid, path = _real_track()
    tgrid, tpath = interop.grid_map(grid), interop.path_data(path)
    jc = jl.occupied_cell_table(grid.occ)
    tc = tl.occupied_cell_table(tgrid.occ)
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jslack, tslack = jl.waypoint_slack(path), tl.waypoint_slack(tpath)
    assert math.isclose(tslack, jslack, rel_tol=1.2e-7)
    radius = 1.0 + jslack
    jw = jl.waypoint_cell_table(jc, grid, path, radius)
    tw = tl.waypoint_cell_table(tc, tgrid, tpath, radius)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tw.shape[1] < 0.75 * tc.shape[0]  # pruning pays on both maps


def test_march_fleet_equals_single_scans(sc):
    """The fleet scan is the single-pose scan lane by lane, bitwise."""
    tg, cfg = sc["tgrid"], sc["tcfg"]
    x, y, psi = sc["tpose"]
    fleet = tl.scan_fleet(tg, x, y, psi, cfg, backend="march")
    assert fleet.ranges.shape == (B, cfg.n_beams)
    for b in (0, 7):
        one = tl.scan(tg, x[b], y[b], psi[b], cfg)
        for f, g in zip(fleet, one):
            assert torch.equal(f[b], g)
    m = tl.measurements(fleet)
    assert m.shape == (B, 2, cfg.n_beams)
    assert torch.equal(m[:, 1], fleet.ranges)


def test_cells_matches_conservative(sc):
    """The cells sweep implements scan(conservative=True)'s ray-square
    test: same hits, ranges within one cell on corner-grazing ties, > 95 %
    exact (the JAX package's bar for its own pair)."""
    tg, cfg = sc["tgrid"], sc["tcfg"]
    x, y, psi = sc["tpose"]
    a = tl.scan_fleet(tg, x, y, psi, cfg, cells=sc["tcells"], backend="cells")
    b = tl.scan(tg, x, y, psi, cfg, conservative=True)
    assert torch.equal(a.hit, b.hit)
    d = (a.ranges - b.ranges).abs()
    res = float(tg.resolution)
    assert float(d.max()) <= res + 1e-6
    assert float((d <= 1e-6).float().mean()) > 0.95


def test_cells_pruned_and_chunked_identical(sc):
    """The per-waypoint table and any chunking give the global sweep's
    output bit for bit (ties go to the smallest cell id in every chunk)."""
    tg, cfg, path = sc["tgrid"], sc["tcfg"], sc["tpath"]
    x, y, psi = sc["tpose"]
    wp = torch.tensor([int(torch.argmin((path.x - x[b]) ** 2
                                        + (path.y - y[b]) ** 2))
                       for b in range(B)], dtype=torch.int32)
    ref = tl.scan_fleet(tg, x, y, psi, cfg, cells=sc["tcells"],
                        backend="cells")
    runs = [tl.scan_fleet(tg, x, y, psi, cfg, cells=sc["tcells"],
                          backend="cells", chunk=512, max_elems=1 << 16),
            tl.scan_fleet(tg, x, y, psi, cfg, cells=sc["twpc"],
                          backend="cells", wp_id=wp),
            tl.scan_fleet(tg, x, y, psi, cfg, cells=sc["twpc"],
                          backend="cells", wp_id=wp, chunk=1000,
                          max_elems=3 * 1000 * 91)]
    for out in runs:
        for f, g in zip(out, ref):
            assert torch.equal(f, g)
    assert bool(ref.hit.any()) and not bool(ref.hit.all())


def _jax_scan(sc, backend):
    x, y, psi = sc["jpose"]
    cfg, grid = sc["jcfg"], sc["grid"]
    if backend == "march":
        return jl.scan_fleet(grid, x, y, psi, cfg, backend="march")
    return jax.jit(lambda u, v, w: jl.scan_fleet(
        grid, u, v, w, cfg, cells=sc["jcells"], backend="cells"))(x, y, psi)


@pytest.mark.parametrize("backend", ["march", "cells", "cells_pruned"])
def test_scan_vs_jax(sc, backend):
    x, y, psi = sc["tpose"]
    tg, cfg = sc["tgrid"], sc["tcfg"]
    j = _jax_scan(sc, "march" if backend == "march" else "cells")
    if backend == "cells_pruned":
        # each pose's nearest waypoint, within the table's slack
        wp = torch.tensor([int(torch.argmin((sc["tpath"].x - x[b]) ** 2
                                            + (sc["tpath"].y - y[b]) ** 2))
                           for b in range(B)], dtype=torch.int32)
        t = tl.scan_fleet(tg, x, y, psi, cfg, cells=sc["twpc"],
                          backend="cells", wp_id=wp)
    else:
        t = tl.scan_fleet(tg, x, y, psi, cfg, cells=sc["tcells"],
                          backend=backend)
    np.testing.assert_array_equal(t.angles.numpy()[0],
                                  tl.beam_angles(cfg, "cpu").numpy())
    jhit = np.asarray(j.hit)
    assert (t.hit.numpy() == jhit).mean() >= 0.999
    both = t.hit.numpy() & jhit
    assert both.mean() > 0.3
    res = float(tg.resolution)
    # hit cells from the hit centres in float64 (XLA:CPU rounds m2w's
    # (px + 0.5) * res + origin through an FMA: the centres differ by ulps)
    org = np.asarray(sc["grid"].origin, np.float64)
    cell = lambda xy: np.floor((np.asarray(xy, np.float64) - org) / res)
    dc = np.abs(cell(t.hit_xy.numpy()) - cell(j.hit_xy)).max(-1)
    assert dc[both].max() <= 1  # at most one cell apart
    same = both & (dc == 0)
    assert same.mean() >= 0.95 * both.mean()
    jr = np.asarray(j.ranges)
    np.testing.assert_allclose(t.ranges.numpy()[same], jr[same], rtol=0,
                               atol=4.8e-7)
    assert np.abs(t.ranges.numpy() - jr)[both].max() <= res * math.sqrt(2) + 1e-6
    miss = ~t.hit.numpy() & ~jhit
    assert (t.ranges.numpy()[miss] == cfg.range).all()


@pytest.fixture(scope="module")
def jscans(sc):
    """The JAX package's march scans, carried across: both packages' map
    write-backs then start from the very same scans."""
    j = _jax_scan(sc, "march")
    return j, interop.lidar_scan(j)


def test_free_space_pixels_bitwise(sc, jscans):
    j, t = jscans
    jf = jax.vmap(lambda a, b, c, s: jl.free_space_pixels(sc["grid"], a, b, c, s)
                  )(*sc["jpose"], j)
    tf = tl.free_space_pixels(sc["tgrid"], *sc["tpose"], t)
    for a, b in zip(tf, jf):
        assert a.shape == (B, 91 * 64)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _known(sc, lanes, seed):
    """Known maps that the true world's scans change: the true grid with
    every 7th row cleared (hits write walls back) and 40 extra occupied
    cells (observed-free clearing removes those in view); (H, W) for
    ``lanes`` None, else (lanes, H, W) with distinct cells per lane."""
    rng = np.random.default_rng(seed)
    occ = np.asarray(sc["grid"].occ).copy()
    occ[::7] = 1.0
    if lanes is None:
        occ[rng.integers(0, 500, 40), rng.integers(0, 500, 40)] = 0.0
        return occ
    occ = np.broadcast_to(occ, (lanes,) + occ.shape).copy()
    for b in range(lanes):
        occ[b, rng.integers(0, 500, 40), rng.integers(0, 500, 40)] = 0.0
    return occ


@pytest.mark.parametrize("clear_free", [False, True])
def test_update_grid_from_scan_bitwise(sc, jscans, clear_free):
    """One lane's scatter update (.at[].min / .max) equals the JAX one."""
    j, t = jscans
    occ = _known(sc, None, 4)
    jgrid = sc["grid"].replace(occ=jnp.asarray(occ))
    tgrid = interop.grid_map(jgrid)
    for b in (0, 5):
        jg = jl.update_grid_from_scan(
            jgrid, *(v[b] for v in sc["jpose"]),
            jax.tree.map(lambda a: a[b], j), sc["jcfg"],
            clear_free=clear_free)
        tg = tl.update_grid_from_scan(
            tgrid, *(v[b] for v in sc["tpose"]),
            type(t)(*(a[b] for a in t)), sc["tcfg"], clear_free=clear_free)
        np.testing.assert_array_equal(tg.occ.numpy(), np.asarray(jg.occ))
        assert (tg.occ.numpy() != occ).any()


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("clear_free", [False, True])
def test_fleet_writeback_bitwise(sc, jscans, shared, clear_free):
    """Dense masks (index_put_ of constants) equal the JAX package's
    one-hot-matmul masks, and the port's scatter write-back equals its
    dense one, per lane and pooled."""
    j, t = jscans
    occ = _known(sc, None if shared else B, 5)
    jo = jl.fleet_writeback(sc["grid"], jnp.asarray(occ), *sc["jpose"], j,
                            sc["jcfg"], clear_free=clear_free, shared=shared)
    to = tl.fleet_writeback(sc["tgrid"], interop.occupancy(occ),
                            *sc["tpose"], t, sc["tcfg"],
                            clear_free=clear_free, shared=shared)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    scat = tl.scatter_writeback_(sc["tgrid"], interop.occupancy(occ),
                                 *sc["tpose"], t, clear_free=clear_free,
                                 shared=shared)
    assert torch.equal(scat, to)
    changed = (to.numpy() != occ).sum()
    assert changed > 0  # the scans did write something


def test_scatter_writeback_refuses_aliased_stack(sc, jscans):
    _, t = jscans
    occ = sc["tgrid"].occ.expand(B, -1, -1)
    with pytest.raises(ValueError, match="contiguous"):
        tl.scatter_writeback_(sc["tgrid"], occ, *sc["tpose"], t)


def _hit_cells(grid, scans, H, W):
    """(lane, cell) pairs of every hit beam."""
    hpx, hpy = tl.hit_pixels(grid, scans, H, W)
    lane = torch.arange(hpx.shape[0])[:, None].expand_as(hpx)
    m = scans.hit
    return set(zip(lane[m].tolist(), (hpy[m] * W + hpx[m]).tolist()))


def test_lidar_fleet_per_step_vs_jax(sc):
    """B = 4, 6 steps from an all-free known map, march scans, scatter
    write-back; every step both packages start from the JAX run's exact
    state and maps.  The written maps are bitwise equal wherever the two
    packages' scans agree; the logs meet the bars of
    tests/test_torch_dynamic.py (whose docstring points to the measurements
    behind them)."""
    B, T = 4, 6
    jscan = jbuild_scan(sc["grid"], sc["path"], sc["mpc_cfg"].n_scan_samples)
    tscan = interop.scanline_table(jscan)
    jcfg = dataclasses.replace(sc["mpc_cfg"], R=(0.5, 0.01))
    tmodel, tcfg = port_configs(R=(0.5, 0.01))
    jlidar, tlidar = JLidarConfig(**LOOP), LidarConfig(**LOOP)
    grid, tgrid = sc["grid"], sc["tgrid"]
    H, W = tgrid.occ.shape
    wp, ey = jfeasible(grid, sc["path"], jcfg, sc["model_cfg"], B,
                       np.random.default_rng(3))
    jst = jinit_fleet(sc["path"], jcfg.N, B, e_y0=ey, wp_id0=wp)
    occ = jnp.ones((B, H, W), jnp.float32)
    jscan_jit = jax.jit(lambda s: jl.scan_fleet(grid, s.x, s.y, s.psi, jlidar,
                                              backend="march"))
    fields = ("x", "y", "psi", "v", "s", "e_y")
    d = {f: [] for f in fields}
    ok_t, ok_j, rp_t, rp_j = [], [], [], []
    n_diff = n_written = 0
    for _ in range(T):
        pst = interop.car_state(jst)
        pst.solver.rho = torch.full_like(pst.solver.rho, tcfg.solver.rho)
        pocc = interop.occupancy(occ)
        tres, tocc = tsim.simulate_lidar_fleet(
            tgrid, GridMap(occ=pocc, origin=tgrid.origin,
                           resolution=tgrid.resolution),
            sc["tpath"], tcfg, tmodel, SimConfig(max_steps=1), tlidar, pst,
            table=tscan, scan_backend="march",
            writeback_backend="scatter")
        jres, occ_next = jlidar_fleet(
            grid, grid.replace(occ=occ), sc["path"], jcfg, sc["model_cfg"],
            JSimConfig(max_steps=1), jlidar, jst, table=jscan,
            scan_backend="march", writeback_backend="scatter")
        # maps: equal wherever the scans agree
        ts = tl.scan_fleet(tgrid, pst.x, pst.y, pst.psi, tlidar, backend="march")
        js = interop.lidar_scan(jscan_jit(jst))
        tc, jc = _hit_cells(tgrid, ts, H, W), _hit_cells(tgrid, js, H, W)
        diff = (tocc.numpy() != np.asarray(occ_next))
        cells = {(b, c) for b, c in zip(*np.nonzero(diff.reshape(B, -1)))}
        assert cells <= tc ^ jc, "maps differ where the scans agree"
        n_diff += len(cells)
        n_written += len(tc | jc)
        jst, occ = jres.final_state, occ_next
        tlog = tres.log
        jlog = jax.tree.map(lambda a: np.asarray(a[0]), jres.log)
        for f in fields:
            d[f].append(np.abs(getattr(tlog, f)[0].numpy() - getattr(jlog, f)))
        ok_t.append(tlog.ok[0].numpy())
        ok_j.append(jlog.ok)
        rp_t.append(tlog.r_prim[0].numpy())
        rp_j.append(jlog.r_prim)
    assert n_diff <= 0.01 * n_written, (n_diff, n_written)
    assert int((np.asarray(occ) < 0.5).sum()) > 1000  # the fleet mapped
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
