"""The port's LiDAR in the loop on the CPU: the single-car loop from an
all-free known map (tests/test_lidar_loop.py's checks) and the backend
policy.  The fleet step's parity with the JAX package is in
tests/test_torch_lidar.py."""

import dataclasses
import inspect

import pytest
import torch

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import LidarConfig, SimConfig
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from tests.test_torch_setup import jax_scenario, port_configs

LIDAR = dict(FoV=360, range=1.0, resolution=4, n_ray_samples=192)


@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    s.update(tgrid=interop.grid_map(s["grid"]),
             tpath=interop.path_data(s["path"]))
    return s


def test_lidar_loop_discovers_map_and_drives(sc):
    """tests/test_lidar_loop.py's single-car check, through the port: from
    an all-free known map the scans populate it and the car still tracks
    the path."""
    tmodel, tcfg = port_configs()
    path = compute_speed_profile(sc["tpath"], sc["speed_cfg"])
    known0 = dataclasses.replace(sc["tgrid"],
                                 occ=torch.ones_like(sc["tgrid"].occ))
    res, known = tsim.simulate_lidar_loop(sc["tgrid"], known0, path, tcfg,
                                          tmodel, SimConfig(max_steps=40),
                                          LidarConfig(**LIDAR))
    assert known.occ.shape == sc["tgrid"].occ.shape
    assert res.log.e_y.shape == (40,)
    n_found = int((known0.occ - known.occ).sum())
    assert n_found > 200, f"only {n_found} cells discovered"
    assert float(res.final_state.s[0]) > 1.0
    assert not bool(res.final_state.failed[0])
    assert float(res.log.e_y.abs().max()) < 0.25


def test_resolve_lidar_backends_policy():
    """The card follows the JAX package's TPU policy, the CPU its CPU
    policy (nothing is allocated: the device is only named)."""
    r = tsim.resolve_lidar_backends
    assert r(False, False, "auto", "auto", device="cpu") == ("march", "scatter")
    assert r(True, False, "auto", "auto", device="cpu") == ("march", "scatter")
    assert r(True, False, "auto", "auto", multi_device=True,
             device="cpu") == ("march", "dense")
    assert r(False, False, "auto", "auto", device="cuda") == ("cells", "packed")
    assert r(False, True, "auto", "auto", device="cuda") == ("cells", "dense")
    assert r(True, False, "auto", "auto", device="cuda") == ("cells", "dense")
    assert r(False, False, "march", "fused",
             device=torch.device("cuda", 0)) == ("march", "fused")
    assert r(False, False, "auto", "auto") == ("cells", "packed")  # the card
    with pytest.raises(ValueError, match="fused"):
        r(False, True, "auto", "fused", device="cpu")
    with pytest.raises(ValueError, match="packed"):
        r(True, False, "auto", "packed", device="cuda")
    with pytest.raises(ValueError, match="dense"):
        r(True, False, "auto", "scatter", multi_device=True, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        r(False, False, "auto", "onehot", device="cpu")
    assert inspect.signature(tsim.resolve_lidar_backends).parameters[
        "device"].default == "cuda"
