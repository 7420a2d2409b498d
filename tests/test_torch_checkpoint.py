"""Port parity, checkpoint / resume and the profiling helpers
(``utils/checkpoint.py``, ``utils/profiling.py``), on the CPU.

* A ``.npz`` checkpoint written by either package loads in the other bit
  for bit (the fleet state and the LiDAR fleet's ``(CarState, occ)``
  carry): the same leaves in ``jax.tree.flatten``'s order.
* Resume is bitwise: T1 steps, save, load, T2 steps equals T1 + T2 steps
  (tests/test_utils.py's checkpoint tests, on the port); the LiDAR carry
  too; the ``torch.save`` pair round-trips.
* The profiling helpers keep tests/test_utils.py's contracts.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.simulation import init_fleet as jinit_fleet
from multi_purpose_mpc_tpu.utils import checkpoint as jck

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import LidarConfig, SimConfig
from multi_purpose_mpc_tpu_torch.ops.grid import make_grid_map
from multi_purpose_mpc_tpu_torch.utils import checkpoint as tck
from multi_purpose_mpc_tpu_torch.utils.profiling import (fence,
                                                         scan_marginal_cost,
                                                         time_stages, timeit,
                                                         trace)
from multi_purpose_mpc_tpu_torch.utils.tree import leaves
from tests.test_torch_setup import jax_scenario, port_configs


@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    model, cfg = port_configs()
    s.update(tgrid=interop.grid_map(s["grid"]), tpath=interop.path_data(s["path"]),
             tmodel=model, tcfg=cfg)
    return s


def _random_jax_carry(sc, seed):
    """A JAX fleet state of 3 lanes with every leaf drawn at random (each in
    its dtype), and a (3, H, W) map stack: the LiDAR fleet's carry."""
    rng = np.random.default_rng(seed)
    state = jinit_fleet(sc["path"], sc["mpc_cfg"].N, 3)

    def draw(x):
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return jnp.asarray(rng.random(x.shape) < 0.5)
        if np.issubdtype(x.dtype, np.integer):
            return jnp.asarray(rng.integers(-50, 50, x.shape), x.dtype)
        return jnp.asarray(rng.normal(0, 1, x.shape), x.dtype)

    occ = (rng.random((3,) + np.asarray(sc["grid"].occ).shape) < 0.5)
    return jax.tree.map(draw, state), jnp.asarray(occ, jnp.float32)


def _port_like(sc):
    state = tsim.init_fleet(sc["tpath"], sc["tcfg"].N, 3)
    return state, torch.zeros((3,) + tuple(sc["tgrid"].occ.shape))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_packages_bitwise(sc, tmp_path, writer):
    jcarry = _random_jax_carry(sc, seed=11)
    path = str(tmp_path / "carry.npz")
    if writer == "jax":
        jck.save_fleet_state(path, jcarry, step=17)
        got, step = tck.load_fleet_state(path, like=_port_like(sc))
        got = [x.numpy() for x in leaves(got)]
    else:
        port = (interop.car_state(jcarry[0]), torch.tensor(np.asarray(jcarry[1])))
        tck.save_fleet_state(path, port, step=17)
        zeros = jax.tree.map(jnp.zeros_like, jcarry)
        got, step = jck.load_fleet_state(path, like=zeros)
        got = [np.asarray(x) for x in jax.tree.leaves(got)]
    ref = [np.asarray(x) for x in jax.tree.leaves(jcarry)]
    assert step == 17 and len(got) == len(ref) == 20
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f"leaf_{i}")


def test_load_refuses_another_state(sc, tmp_path):
    state, _ = _port_like(sc)
    path = str(tmp_path / "fleet.npz")
    tck.save_fleet_state(path, state)
    with pytest.raises(ValueError, match="shape"):
        tck.load_fleet_state(path, like=tsim.init_fleet(sc["tpath"],
                                                        sc["tcfg"].N, 2))
    with pytest.raises(ValueError, match="leaves"):
        tck.load_fleet_state(path, like=(state, state.x))


def _roll(sc, state, steps):
    return tsim.simulate_fleet(sc["tgrid"], sc["tpath"], sc["tcfg"],
                               sc["tmodel"], SimConfig(max_steps=steps), state)


def _assert_same(a, b):
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b))):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def test_resume_equals_the_uninterrupted_run(sc, tmp_path):
    """3 steps, checkpoint, load, 3 steps: the log and the final state of
    the 6-step run, bit for bit."""
    fleet0 = tsim.init_fleet(sc["tpath"], sc["tcfg"].N, 3,
                             e_y0=torch.tensor([-0.02, 0.0, 0.02]))
    full = _roll(sc, fleet0, 6)
    mid = _roll(sc, fleet0, 3).final_state
    path = str(tmp_path / "fleet.npz")
    tck.save_fleet_state(path, mid, step=3)
    restored, step = tck.load_fleet_state(path, like=mid)
    assert step == 3
    _assert_same(restored, mid)
    rest = _roll(sc, restored, 3)
    _assert_same(rest.log, type(full.log)(*(f[3:] for f in full.log)))
    _assert_same(rest.final_state, full.final_state)


def test_lidar_fleet_checkpoint_resume(sc, tmp_path):
    """The mapping fleet's ``(CarState, known_occ)`` carry snapshots and
    resumes bit for bit (tests/test_utils.py:71-111)."""
    known0 = make_grid_map(torch.ones_like(sc["tgrid"].occ),
                           sc["tgrid"].origin, sc["tgrid"].resolution,
                           device="cpu")
    lidar = LidarConfig(FoV=360, range=1.0, resolution=8, n_ray_samples=128)
    fleet0 = tsim.init_fleet(sc["tpath"], sc["tcfg"].N, 2,
                             wp_id0=torch.tensor([0, 70], dtype=torch.int32))

    def roll(state, occ, steps):
        return tsim.simulate_lidar_fleet(
            sc["tgrid"], dataclasses.replace(known0, occ=occ), sc["tpath"],
            sc["tcfg"], sc["tmodel"], SimConfig(max_steps=steps,
                                                static_grid=False),
            lidar, state)

    res, occ_mid = roll(fleet0, known0.occ, 3)
    assert bool((occ_mid < 0.5).any())
    path = str(tmp_path / "lidar_fleet.npz")
    tck.save_fleet_state(path, (res.final_state, occ_mid), step=3)
    (restored, occ_restored), step = tck.load_fleet_state(
        path, like=(res.final_state, occ_mid))
    assert step == 3
    assert torch.equal(occ_restored, occ_mid)
    cont, occ_c = roll(res.final_state, occ_mid, 2)
    resumed, occ_r = roll(restored, occ_restored, 2)
    _assert_same(resumed.log, cont.log)
    assert torch.equal(occ_r, occ_c)


def test_torch_save_checkpoint_roundtrip(sc, tmp_path):
    """The counterpart of the JAX package's Orbax pair: ``torch.save`` of
    the flat leaves, loaded with ``weights_only=True``."""
    jstate, _ = _random_jax_carry(sc, seed=5)
    state = interop.car_state(jstate)
    tck.save_fleet_state_torch(str(tmp_path / "ck"), state, step=6)
    assert os.path.exists(tmp_path / "ck" / "step_6")
    like = tsim.init_fleet(sc["tpath"], sc["tcfg"].N, 3)
    restored = tck.load_fleet_state_torch(str(tmp_path / "ck"), like, step=6)
    _assert_same(restored, state)


def test_scan_marginal_cost_orders_ops():
    """A matmul costs more per iteration than an elementwise add; both
    finite and >= 0 (tests/test_utils.py:52-70; 512 x 512 so that the
    matmul's cost stands well above the CPU's timing noise)."""
    a = torch.ones((512, 512))

    def perturb(args, i):
        (x,) = args
        return (x + (i % 2) * 1e-6,)

    t_mm = scan_marginal_cost(lambda x: (x @ x) @ x, (a,), perturb,
                              steps=16, repeats=3)
    t_add = scan_marginal_cost(lambda x: x + 1.0, (a,), perturb, steps=16,
                               repeats=3)
    assert np.isfinite(t_mm) and np.isfinite(t_add)
    assert t_mm >= 0.0 and t_add >= 0.0
    assert t_mm > t_add


def test_profiling_helpers(tmp_path):
    f = lambda x: (x * 2).sum()
    x = torch.ones((64, 64))
    assert fence(x) is x
    assert timeit(f, x, warmup=1, iters=3) > 0
    stages = time_stages({"double": lambda: f(x)}, warmup=1, iters=2)
    assert stages["double"] > 0
    with trace(str(tmp_path / "tr")) as d:
        f(x)
    with open(os.path.join(d, "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)


def test_timeit_agrees_with_manual_timing(sc):
    """``timeit`` against a hand-timed loop of the same rollout: the same
    order of magnitude (tests/test_utils.py:140-178)."""
    fleet0 = tsim.init_fleet(sc["tpath"], sc["tcfg"].N, 8)
    run = lambda: _roll(sc, fleet0, 1).log.x
    t_helper = timeit(run, warmup=1, iters=3)
    manual = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(run().sum())
        manual.append(time.perf_counter() - t0)
    t_manual = sorted(manual)[1]
    assert t_manual / 3 < t_helper < t_manual * 3 + 0.05
