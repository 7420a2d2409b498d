"""Port parity, the fused map write-back + extraction (kernels K5 and K6)
and the per-lane LiDAR fleet rollouts, on the CPU.

* K5's plain version against the JAX package's
  ``fleet_writeback(clear_free=False)`` -> ``extract_occ_gather``, the pair
  JAX's own tests hold the Pallas kernel to (tests/test_mapping_fused.py):
  bitwise (integer work on the same data).  A share of the hits lands on
  horizon scanline samples, so an extraction that read the grid before the
  write-back would fail.
* ``pack_rows`` / ``unpack_rows`` against the JAX package's, bitwise,
  including row 31 (the int32 sign bit).  K6's plain version equals K5's.
* Rollouts: with the known map equal to the true one every write-back
  backend reproduces the dynamic-grid fleet bit for bit; from an all-free
  known map the four backends agree bit for bit with each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.ops.corridor_extract import (
    build_scanline_table as jbuild_scan, extract_occ_gather as jgather,
    horizon_tables as jhorizon_tables)
from multi_purpose_mpc_tpu.ops.grid import m2w as jm2w
from multi_purpose_mpc_tpu.ops.lidar import LidarScan as JScan
from multi_purpose_mpc_tpu.ops.lidar import fleet_writeback as jwriteback
from multi_purpose_mpc_tpu.ops.mapping_pallas import pack_rows as jpack
from multi_purpose_mpc_tpu.ops.mapping_pallas import unpack_rows as junpack
from multi_purpose_mpc_tpu.ops.path import gather_waypoint_index as jgwi
from multi_purpose_mpc_tpu.simulation import feasible_starts as jfeasible
from multi_purpose_mpc_tpu.simulation import init_fleet as jinit_fleet

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import LidarConfig, SimConfig
from multi_purpose_mpc_tpu_torch.ops import corridor_extract as tce
from multi_purpose_mpc_tpu_torch.ops import mapping as tm
from multi_purpose_mpc_tpu_torch.ops.lidar import hit_pixels
from tests.test_torch_setup import jax_scenario, port_configs

B, NB = 4, 91
LIDAR = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)


@pytest.fixture(scope="module")
def sc():
    """Sim_Track, B = 4 per-lane grids salted with extra occupied cells and
    91 synthetic beams per lane: ~60 % hits near the track, and 24 hits per
    lane placed on free horizon scanline samples of that lane."""
    s = jax_scenario()
    grid, path, cfg = s["grid"], s["path"], s["mpc_cfg"]
    jscan = jbuild_scan(grid, path, cfg.n_scan_samples)
    rng = np.random.default_rng(3)
    wp = jnp.asarray(rng.integers(0, path.n_wp, B), jnp.int32)
    idx = jax.vmap(lambda w: jgwi(path, w + 1, jnp.arange(cfg.N)))(wp)
    occ_b = np.broadcast_to(np.asarray(grid.occ), (B,) + grid.occ.shape).copy()
    for b in range(B):
        occ_b[b, rng.integers(0, 500, 30), rng.integers(0, 500, 30)] = 0.0
    k = rng.integers(0, path.n_wp, (B, NB))
    hx = np.asarray(path.x)[k] + rng.uniform(-0.1, 0.1, (B, NB))
    hy = np.asarray(path.y)[k] + rng.uniform(-0.1, 0.1, (B, NB))
    hit = rng.random((B, NB)) < 0.6
    px, py, inb = (np.asarray(a) for a in jhorizon_tables(jscan, idx)[:3])
    on_samples = 0
    for b in range(B):
        free = np.argwhere(inb[b] & (occ_b[b, py[b], px[b]] > 0.5))
        pick = free[rng.choice(len(free), 24, replace=False)]
        beams = rng.choice(NB, 24, replace=False)
        cx, cy = jm2w(grid, px[b][tuple(pick.T)], py[b][tuple(pick.T)])
        hx[b, beams], hy[b, beams] = np.asarray(cx), np.asarray(cy)
        hit[b, beams] = True
        on_samples += len(beams)
    scans = JScan(angles=jnp.zeros((B, NB), jnp.float32),
                  ranges=jnp.ones((B, NB), jnp.float32), hit=jnp.asarray(hit),
                  hit_xy=jnp.asarray(np.stack([hx, hy], -1), jnp.float32))
    s.update(jscan=jscan, tscan=interop.scanline_table(jscan), idx=idx,
             occ_b=occ_b, jscans=scans, tscans=interop.lidar_scan(scans),
             tgrid=interop.grid_map(grid), tpath=interop.path_data(path))
    assert on_samples == 24 * B
    return s


def _port_inputs(sc):
    tg = sc["tgrid"]
    H, W = tg.occ.shape
    hpx, hpy = hit_pixels(tg, sc["tscans"], H, W)
    h = tce.horizon_tables(sc["tscan"], torch.tensor(np.asarray(sc["idx"])))
    return hpx, hpy, sc["tscans"].hit, h.px, h.py


def test_k5_plain_bitwise_vs_jax(sc):
    occ_ref = jwriteback(sc["grid"], jnp.asarray(sc["occ_b"]), None, None,
                         None, sc["jscans"], None, clear_free=False,
                         shared=False)
    pxh, pyh = jhorizon_tables(sc["jscan"], sc["idx"])[:2]
    vals_ref = np.asarray(jgather(occ_ref, pxh, pyh))
    occ = interop.occupancy(sc["occ_b"])
    new_occ, vals = tm.writeback_extract(occ, *_port_inputs(sc))
    np.testing.assert_array_equal(new_occ.numpy(), np.asarray(occ_ref))
    np.testing.assert_array_equal(vals.numpy(), vals_ref)
    # the write-back reached the sampled cells: reading the grid before it
    # would give different values
    before = tce.extract_occ_gather(occ, *_port_inputs(sc)[3:])
    assert int((before != vals).sum()) >= 24 * B
    assert torch.equal(occ, interop.occupancy(sc["occ_b"]))  # input untouched


def test_pack_unpack_bitwise_vs_jax(sc):
    """The JAX layout, padded to a multiple of 32 rows (window_rows = 128 <
    H, so the JAX Hp is the port's), row 31 included."""
    rng = np.random.default_rng(7)
    occ = (rng.random((2, 70, 40)) > 0.3).astype(np.float32)
    occ[:, 31, :] = 0.0  # the sign-bit row of word 0 all occupied
    occ[:, 63, :] = 1.0
    occ[1, 31, ::3] = 1.0
    for grid, jrows in ((occ, 16), (sc["occ_b"], sc["jscan"].window_rows)):
        pk = tm.pack_rows(torch.tensor(grid))
        jpk = np.asarray(jpack(jnp.asarray(grid), jrows))
        assert pk.dtype == torch.int32 and pk.shape == jpk.shape
        np.testing.assert_array_equal(pk.numpy(), jpk)
        H = grid.shape[-2]
        np.testing.assert_array_equal(tm.unpack_rows(pk, H).numpy(), grid)
        np.testing.assert_array_equal(tm.unpack_rows(pk, H).numpy(),
                                      np.asarray(junpack(jnp.asarray(jpk), H)))
    assert tm.pack_rows(torch.tensor(sc["occ_b"])).shape == (B, 16, 500)
    # bit 31 set: the sign bit is a cell
    assert bool((tm.pack_rows(torch.tensor(occ))[1, 0] < 0).any())


def test_k6_plain_equals_k5_plain(sc):
    occ = interop.occupancy(sc["occ_b"])
    args = _port_inputs(sc)
    o5, v5 = tm.writeback_extract(occ, *args)
    pk, v6 = tm.writeback_extract_packed(tm.pack_rows(occ), *args)
    H = occ.shape[1]
    assert torch.equal(tm.unpack_rows(pk, H), o5)
    assert torch.equal(v6, v5)
    # pad rows stay free: hits are clipped to H - 1
    assert bool((tm.unpack_rows(pk, pk.shape[1] * 32)[:, H:] == 1.0).all())


def test_cuda_wrappers_refuse_cpu_tensors(sc):
    occ = interop.occupancy(sc["occ_b"])
    args = _port_inputs(sc)
    with pytest.raises(ValueError, match="CUDA"):
        tm.writeback_extract_cuda(occ, *args)
    with pytest.raises(ValueError, match="CUDA"):
        tm.writeback_extract_packed_cuda(tm.pack_rows(occ), *args)


# ---------------------------------------------------------------------------
# Rollouts
# ---------------------------------------------------------------------------

STEPS = 3


@pytest.fixture(scope="module")
def fleet(sc):
    """B = 3 feasible starts through the JAX package, carried across, the
    port's configs and the dynamic-grid reference rollout."""
    wp, ey = jfeasible(sc["grid"], sc["path"], sc["mpc_cfg"],
                       sc["model_cfg"], 3, np.random.default_rng(11))
    jst = jinit_fleet(sc["path"], sc["mpc_cfg"].N, 3, e_y0=ey, wp_id0=wp)
    model, cfg = port_configs()
    kw = dict(path=sc["tpath"], cfg=cfg, model=model,
              state0=interop.car_state(jst))
    dyn = tsim.simulate_fleet(sc["tgrid"], sim=SimConfig(max_steps=STEPS,
                                                         static_grid=False),
                              table=sc["tscan"], **kw)
    free = dataclasses.replace(sc["tgrid"], occ=torch.ones_like(sc["tgrid"].occ))
    return dict(kw=kw, dyn=dyn, free=free)


def _lidar(sc, fleet, known, wb, scan="march"):
    return tsim.simulate_lidar_fleet(sc["tgrid"], known,
                                     sim=SimConfig(max_steps=STEPS),
                                     lidar=LIDAR, table=sc["tscan"],
                                     scan_backend=scan, writeback_backend=wb,
                                     **fleet["kw"])


def _logs_equal(a, b):
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)


@pytest.mark.parametrize("wb,scan", [("scatter", "march"), ("dense", "march"),
                                     ("fused", "march"), ("packed", "march"),
                                     ("packed", "cells")])
def test_known_true_reproduces_dynamic_fleet(sc, fleet, wb, scan):
    """Scans of the true world only re-mark occupied cells, so every
    write-back backend drives exactly as the dynamic-grid fleet."""
    res, occ = _lidar(sc, fleet, sc["tgrid"], wb, scan)
    _logs_equal(res.log, fleet["dyn"].log)
    assert occ.shape == (3,) + tuple(sc["tgrid"].occ.shape)
    assert torch.equal(occ, sc["tgrid"].occ.expand_as(occ))


@pytest.fixture(scope="module")
def discovery(sc, fleet):
    return {wb: _lidar(sc, fleet, fleet["free"], wb)
            for wb in ("scatter", "dense", "fused", "packed")}


@pytest.mark.parametrize("wb", ["scatter", "fused", "packed"])
def test_discovery_backends_agree(discovery, wb):
    """From an all-free known map: every backend's log and final maps equal
    the dense write-back's bit for bit."""
    ref_res, ref_occ = discovery["dense"]
    res, occ = discovery[wb]
    _logs_equal(res.log, ref_res.log)
    assert torch.equal(occ, ref_occ)
    found = (occ < 0.5).flatten(1).sum(1)
    assert bool((found > 200).all())
    assert not torch.equal(occ[0], occ[1])  # lanes map their own worlds


def test_lidar_fleet_shared_grid(sc, fleet):
    """One map pooled over the lanes (scatter and dense agree) holds every
    lane's discoveries."""
    out = {wb: tsim.simulate_lidar_fleet(
        sc["tgrid"], fleet["free"], sim=SimConfig(max_steps=2), lidar=LIDAR,
        table=sc["tscan"], scan_backend="march", writeback_backend=wb,
        shared_grid=True, **fleet["kw"]) for wb in ("scatter", "dense")}
    (rs, os_), (rd, od) = out["scatter"], out["dense"]
    _logs_equal(rs.log, rd.log)
    assert torch.equal(os_, od) and os_.shape == sc["tgrid"].occ.shape
    assert int((od < 0.5).sum()) > 200
