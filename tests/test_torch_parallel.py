"""Port parity, the scale-out path: ``parallel/mesh.py`` and
``parallel/fleet.py`` over ``torch.distributed``, on the CPU.

* The mesh's pure logic (``local_lane_slice``, ``round_up_batch``) and
  ``fleet_metrics`` against the JAX package's functions.
* One two-rank gloo launch (tests/torch_dist_worker.py, which imports
  torch and the port only) runs the sharded fleets of the JAX package's
  own tests on their scenarios: the static fleet of
  tests/test_distributed.py (B = 8, T = 4) and the per-lane and
  shared-grid LiDAR fleets of tests/test_fleet.py (B = 8, T = 5,
  ``LidarConfig(FoV=360, range=1.0, resolution=6, n_ray_samples=160)``),
  each held against the port's unsharded run at those files' bars, and
  bit for bit: every lane computes alone, so a rank's block must equal the
  same lanes of one process.  The same ranks pool the shared map's
  observation masks of one JAX scan per lane, which must equal the JAX
  package's single-device pool bit for bit (tests/test_fleet.py's
  ``test_shared_mask_pooling_bitwise``).
"""

import concurrent.futures
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.config import LidarConfig as JLidarConfig
from multi_purpose_mpc_tpu.ops import lidar as jl
from multi_purpose_mpc_tpu.ops.grid import make_grid_map as jmake_grid
from multi_purpose_mpc_tpu.parallel import mesh as jmesh
from multi_purpose_mpc_tpu.simulation import init_fleet as jinit_fleet

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import LidarConfig, SimConfig
from multi_purpose_mpc_tpu_torch.ops.grid import make_grid_map
from multi_purpose_mpc_tpu_torch.parallel import mesh as tmesh
from multi_purpose_mpc_tpu_torch.utils.tree import leaves, tree_map
from tests.test_torch_setup import jax_scenario, port_configs
from torch_dist_worker import launch

B = 8
WORLD = 2
T_FLEET = 4  # tests/test_distributed.py
T_LIDAR = 5  # tests/test_fleet.py
LIDAR = dict(FoV=360, range=1.0, resolution=6, n_ray_samples=160)
RANK_TIMEOUT = 300.0


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_lane_slice_and_round_up_match_jax(n):
    fake_jax_mesh = types.SimpleNamespace(devices=np.empty(n))
    mesh = tmesh.FleetMesh(0, n, torch.device("cpu"))
    for batch in range(0, 40):
        assert (tmesh.round_up_batch(batch, mesh)
                == jmesh.round_up_batch(batch, fake_jax_mesh))
        for i in range(n):
            if batch % n:
                with pytest.raises(ValueError, match="round_up_batch"):
                    tmesh.local_lane_slice(batch, i, n)
                with pytest.raises(ValueError):
                    jmesh.local_lane_slice(batch, i, n)
            else:
                assert (tmesh.local_lane_slice(batch, i, n)
                        == jmesh.local_lane_slice(batch, i, n))


def test_single_process_needs_no_group(monkeypatch):
    """No coordinates and no torchrun environment: no connection attempt,
    a one-rank mesh; an address without a world size is refused."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_distributed(device="cpu") is False
    mesh = tmesh.global_fleet_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        tmesh.init_distributed("localhost:1", device="cpu")


def _jax_metrics(log_np, length):
    jlog = types.SimpleNamespace(**{k: jnp.asarray(v)
                                    for k, v in log_np.items()})
    return {k: np.asarray(v) for k, v in
            jmesh.fleet_metrics(jlog, jnp.float32(length)).items()}


def _port_metrics(log_np, length, mesh=None):
    tlog = types.SimpleNamespace(**{k: torch.tensor(v)
                                    for k, v in log_np.items()})
    return {k: v.numpy() for k, v in tmesh.fleet_metrics(
        tlog, torch.tensor(length, dtype=torch.float32), mesh).items()}


def _assert_metrics_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if k == "max_abs_e_y":
            assert got[k] == ref[k], k
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=0,
                                       err_msg=k)


def test_fleet_metrics_synthetic_log_matches_jax():
    """Random logs (numpy, seeded) through both packages: the five scalars
    within 1e-6, the maximum exact; inactive steps count nowhere."""
    rng = np.random.default_rng(7)
    T, n = 6, 16
    log = dict(s=np.cumsum(rng.uniform(0, 0.5, (T, n)), 0).astype(np.float32),
               v=rng.uniform(0, 1.2, (T, n)).astype(np.float32),
               e_y=rng.normal(0, 0.1, (T, n)).astype(np.float32),
               ok=rng.random((T, n)) < 0.9,
               active=rng.random((T, n)) < 0.8)
    length = 1.7
    _assert_metrics_close(_port_metrics(log, length),
                          _jax_metrics(log, length))
    log["active"][:] = False  # no active step: rates over max(0, 1)
    _assert_metrics_close(_port_metrics(log, length),
                          _jax_metrics(log, length))


def _assert_same_bits(a, b, what):
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b))):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i}"


@pytest.fixture(scope="module")
def run():
    """The scenario, the two ranks' results and the unsharded references,
    computed while the ranks run."""
    s = jax_scenario()
    grid, path = interop.grid_map(s["grid"]), interop.path_data(s["path"])
    model, cfg = port_configs()
    known0 = make_grid_map(torch.ones_like(grid.occ), grid.origin,
                           grid.resolution, device="cpu")
    lidar = LidarConfig(**LIDAR)
    fleet = tsim.init_fleet(path, cfg.N, B,
                            e_y0=torch.linspace(-0.03, 0.03, B))
    lane_fleet = tsim.init_fleet(path, cfg.N, B,
                                 wp_id0=torch.arange(B, dtype=torch.int32) * 25)
    shared_fleet = tsim.init_fleet(
        path, cfg.N, B, wp_id0=torch.arange(B, dtype=torch.int32) * 20)
    lidar_sim = SimConfig(max_steps=T_LIDAR, static_grid=False)

    # the JAX package's single-device mask pool over one march scan per lane
    jlidar = JLidarConfig(**LIDAR)
    jknown = jmake_grid(np.ones_like(np.asarray(s["grid"].occ)),
                        (float(s["grid"].origin[0]), float(s["grid"].origin[1])),
                        float(s["grid"].resolution))
    jfleet = jinit_fleet(s["path"], cfg.N, B,
                         wp_id0=jnp.arange(B, dtype=jnp.int32) * 25)
    h, w = np.asarray(jknown.occ).shape

    @jax.jit
    def jpool(x, y, psi):
        scans = jl.scan_fleet(s["grid"], x, y, psi, jlidar, backend="march")
        hm, fm = jl.fleet_observation_masks(jknown, h, w, x, y, psi, scans,
                                            jlidar, clear_free=True,
                                            shared=True)
        return scans, jl.apply_observation_masks(jknown.occ, hm, fm)

    jscans, jmap = jpool(jfleet.x, jfleet.y, jfleet.psi)
    pose = {k: torch.tensor(np.asarray(getattr(jfleet, k)))
            for k in ("x", "y", "psi")}

    spec = dict(device="cpu", grid=grid, path=path, cfg=cfg, model=model,
                lidar=lidar, known=known0, tasks=dict(
                    fleet=dict(kind="fleet", sim=SimConfig(max_steps=T_FLEET),
                               state=fleet),
                    lanes=dict(kind="lidar", sim=lidar_sim, state=lane_fleet),
                    shared=dict(kind="lidar", sim=lidar_sim, state=shared_fleet,
                                kw=dict(shared_grid=True, clear_free=True)),
                    pool=dict(kind="pool", clear_free=True,
                              scans=interop.lidar_scan(jscans), **pose)))
    with tempfile.TemporaryDirectory() as d, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, spec, WORLD, d, RANK_TIMEOUT)
        ref = dict(
            fleet=tsim.simulate_fleet(grid, path, cfg, model,
                                      SimConfig(max_steps=T_FLEET), fleet),
            lanes=tsim.simulate_lidar_fleet(grid, known0, path, cfg, model,
                                            lidar_sim, lidar, lane_fleet),
            shared=tsim.simulate_lidar_fleet(
                grid, known0, path, cfg, model, lidar_sim, lidar,
                shared_fleet, shared_grid=True, clear_free=True,
                writeback_backend="dense"))
        out = ranks.result()
    return dict(ranks=out, ref=ref, known0=known0, length=path.length,
                jmap=np.asarray(jmap))


def _lanes(out):
    return slice(*out["lanes"])


def test_two_ranks_tile_the_fleet(run):
    for task in ("fleet", "lanes", "shared", "pool"):
        covered = np.zeros(B, bool)
        for r in run["ranks"]:
            sl = _lanes(r[task])
            assert not covered[sl].any(), task
            covered[sl] = True
        assert covered.all(), task
    # the ranks' lanes of a mapping fleet ran on the CPU: no kernel
    for r in run["ranks"]:
        assert not any(r["lanes"]["launches"].values())


def test_sharded_static_fleet_matches_unsharded(run):
    """tests/test_distributed.py's bars (s and x within 1e-6, ok equal),
    and bit for bit; the gathered fleet is the unsharded one."""
    ref = run["ref"]["fleet"]
    for r in run["ranks"]:
        got, sl = r["fleet"]["result"], _lanes(r["fleet"])
        np.testing.assert_allclose(got.final_state.s.numpy(),
                                   ref.final_state.s[sl].numpy(), atol=1e-6)
        np.testing.assert_allclose(got.log.x.numpy(), ref.log.x[:, sl].numpy(),
                                   atol=1e-6)
        np.testing.assert_array_equal(got.log.ok.numpy(),
                                      ref.log.ok[:, sl].numpy())
        _assert_same_bits(got.log, type(ref.log)(*(f[:, sl] for f in ref.log)),
                          "log")
        _assert_same_bits(got.final_state, _take_lanes(ref.final_state, sl),
                          "final state")
        _assert_same_bits(r["fleet"]["full"].log, ref.log, "gathered log")
        _assert_same_bits(r["fleet"]["full"].final_state, ref.final_state,
                          "gathered final state")


def _take_lanes(state, sl):
    return tree_map(lambda x: x[sl], state)


def test_fleet_metrics_over_two_ranks(run):
    """Under the mesh every rank gets the whole fleet's metrics: those of
    the gathered log and of the unsharded run (and of the JAX function on
    that log carried across as numpy)."""
    ref_log = run["ref"]["fleet"].log
    ref_np = {k: getattr(ref_log, k).numpy()
              for k in ("s", "v", "e_y", "ok", "active")}
    length = float(run["length"])
    unsharded = _port_metrics(ref_np, length)
    _assert_metrics_close(unsharded, _jax_metrics(ref_np, length))
    for r in run["ranks"]:
        m = {k: v.numpy() for k, v in r["fleet"]["metrics"].items()}
        _assert_metrics_close(m, unsharded)
        _assert_metrics_close(m, {k: v.numpy() for k, v in
                                  r["fleet"]["metrics_gathered"].items()})


def test_sharded_lidar_fleet_per_lane(run):
    """tests/test_fleet.py's per-lane bands (v of the first 2 steps within
    5e-3, final s within 0.05, map cells differing < 20 % of those found,
    no failed lane), and bit for bit: logs, final states and maps."""
    ref, occ_ref = run["ref"]["lanes"]
    n_disc = float((run["known0"].occ - occ_ref).sum())
    for r in run["ranks"]:
        got, occ, sl = r["lanes"]["result"], r["lanes"]["occ"], _lanes(r["lanes"])
        assert occ.shape == occ_ref[sl].shape
        np.testing.assert_allclose(got.log.v[:2].numpy(),
                                   ref.log.v[:2, sl].numpy(), atol=5e-3)
        np.testing.assert_allclose(got.log.s[-1].numpy(),
                                   ref.log.s[-1, sl].numpy(), atol=0.05)
        assert int((occ != occ_ref[sl]).sum()) < 0.2 * max(n_disc, 1)
        assert not bool(got.final_state.failed.any())
        _assert_same_bits(got.log, type(ref.log)(*(f[:, sl] for f in ref.log)),
                          "log")
        _assert_same_bits(got.final_state, _take_lanes(ref.final_state, sl),
                          "final state")
        assert torch.equal(occ, occ_ref[sl])


def test_sharded_lidar_fleet_shared_grid(run):
    """tests/test_fleet.py's shared-grid bands (v of the first 2 steps
    within 5e-3, cells found within 10 %, no failed lane); the ranks' maps
    equal each other and the unsharded pool's, and the logs bit for bit."""
    ref, occ_ref = run["ref"]["shared"]
    known0 = run["known0"].occ
    n_p = float((known0 - occ_ref).sum())
    maps = [r["shared"]["occ"] for r in run["ranks"]]
    assert torch.equal(maps[0], maps[1])
    for r in run["ranks"]:
        got, occ, sl = r["shared"]["result"], r["shared"]["occ"], _lanes(r["shared"])
        assert occ.shape == known0.shape
        np.testing.assert_allclose(got.log.v[:2].numpy(),
                                   ref.log.v[:2, sl].numpy(), atol=5e-3)
        assert abs(n_p - float((known0 - occ).sum())) < 0.1 * max(n_p, 1)
        assert not bool(got.final_state.failed.any())
        _assert_same_bits(got.log, type(ref.log)(*(f[:, sl] for f in ref.log)),
                          "log")
        assert torch.equal(occ, occ_ref)


def test_two_rank_mask_pool_equals_jax_single_device_pool(run):
    assert (run["jmap"] < 0.5).any()  # the scans hit something
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["pool"]["occ"].numpy(), run["jmap"])


def test_pooling_needs_a_shared_grid(run):
    """A process group pools one shared map; per-lane maps are refused."""
    ref, _ = run["ref"]["lanes"]
    with pytest.raises(ValueError, match="shared_grid"):
        tsim.simulate_lidar_fleet(run["known0"], run["known0"], None, None,
                                  None, SimConfig(max_steps=1), None,
                                  ref.final_state, group=object())
