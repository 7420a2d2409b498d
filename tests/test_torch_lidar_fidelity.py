"""The port's LiDAR scans held to the reference's corner-span algorithm
directly: the float64 oracle ``tests/oracle/lidar.scan_oracle`` (an
independent numpy re-derivation of lidar_model.py:37-108), with the bars
and the scene of tests/test_lidar_fidelity.py — the real map, the
reference's pose (-4.9, -5.0, yaw 0.9) and 3 random free poses, FoV 180°,
range 5 m, 1° a beam, 256 samples a ray.

* ``scan(conservative=True)`` and the ``cells`` sweep (``scan_fleet``, the
  LiDAR fleets' scan on the card): ranges within 1e-5 of the oracle's and
  the same hit flags on every beam;
* the default beam march: the same hit flags on the reference scene, 95 %
  of the ranges within one cell, none more than 4 cells off; across 4
  random poses it never undershoots the oracle by 1.5 cells (no
  hallucinated obstacle) and overshoots by more than 2 cells on < 25 % of
  the beams.

Imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu_torch.config import LidarConfig, real_track_preset
from multi_purpose_mpc_tpu_torch.ops.lidar import (occupied_cell_table, scan,
                                                   scan_fleet)
from multi_purpose_mpc_tpu_torch.utils.maps import load_grid_map
from tests.oracle.lidar import scan_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFERENCE_SCENE = (-4.9, -5.0, 0.9)  # lidar_model.py:142
CFG = LidarConfig(FoV=180.0, range=5.0, resolution=1.0, n_ray_samples=256)


@pytest.fixture(scope="module")
def real_map():
    map_cfg, *_ = real_track_preset(asset_dir=os.path.join(REPO, "assets",
                                                           "maps"))
    grid = load_grid_map(map_cfg, device="cpu")
    return grid, grid.occ.numpy(), (float(grid.origin[0]),
                                    float(grid.origin[1])), \
        float(grid.resolution)


def _poses(occ, origin, res, n=3, seed=3):
    """tests/test_lidar_fidelity.py's poses: the reference scene and random
    free poses whose whole sensor window stays on the map (the march reads
    off-map samples as occupied, the reference skips out-of-image cells)."""
    poses = [REFERENCE_SCENE]
    rng = np.random.default_rng(seed)
    m = int(CFG.range / res) + 2
    h, w = occ.shape
    fy, fx = np.nonzero(occ[m:h - m, m:w - m] > 0.5)
    for si in rng.choice(len(fx), n, replace=False):
        poses.append((origin[0] + (fx[si] + m + 0.5) * res,
                      origin[1] + (fy[si] + m + 0.5) * res,
                      float(rng.uniform(-np.pi, np.pi))))
    return poses


def _oracle(occ, origin, res, pose):
    return scan_oracle(occ, origin, res, *pose, CFG.FoV, CFG.range,
                       CFG.resolution)


def test_conservative_scan_matches_reference_exactly(real_map):
    """Corner-span semantics: ranges to 1e-5 and every hit flag."""
    grid, occ, origin, res = real_map
    for pose in _poses(occ, origin, res):
        oracle = _oracle(occ, origin, res, pose)
        s = scan(grid, *pose, CFG, conservative=True)
        np.testing.assert_allclose(s.ranges.double().numpy(), oracle,
                                   atol=1e-5, err_msg=str(pose))
        np.testing.assert_array_equal(s.hit.numpy(),
                                      oracle < CFG.range - 1e-9)


def test_cells_scan_matches_reference_exactly(real_map):
    """The ``cells`` sweep over the occupied boundary cells, the four poses
    as one fleet: ranges to 1e-5 and every hit flag."""
    grid, occ, origin, res = real_map
    poses = _poses(occ, origin, res)
    x, y, psi = (torch.tensor(c, dtype=torch.float32) for c in zip(*poses))
    s = scan_fleet(grid, x, y, psi, CFG, cells=occupied_cell_table(grid.occ),
                   backend="cells")
    for b, pose in enumerate(poses):
        oracle = _oracle(occ, origin, res, pose)
        np.testing.assert_allclose(s.ranges[b].double().numpy(), oracle,
                                   atol=1e-5, err_msg=str(pose))
        np.testing.assert_array_equal(s.hit[b].numpy(),
                                      oracle < CFG.range - 1e-9)


def test_fast_scan_divergence_bounded(real_map):
    """The beam march against the reference algorithm: the hit flags of
    every beam of the reference scene, 95 % of its ranges within one cell
    and all within 4; across random poses never an obstacle the reference
    does not see, and few beams that overshoot it by more than 2 cells."""
    grid, occ, origin, res = real_map
    oracle = _oracle(occ, origin, res, REFERENCE_SCENE)
    s = scan(grid, *REFERENCE_SCENE, CFG)
    d = np.abs(s.ranges.double().numpy() - oracle)
    np.testing.assert_array_equal(s.hit.numpy(), oracle < CFG.range - 1e-9)
    assert np.percentile(d, 95) < res, np.percentile(d, 95)
    assert d.max() < 4 * res, d.max()

    big = total = 0
    for pose in _poses(occ, origin, res, n=4, seed=11)[1:]:
        o = _oracle(occ, origin, res, pose)
        rr = scan(grid, *pose, CFG).ranges.double().numpy()
        assert (o - rr).max() < 1.5 * res, "march hallucinated an obstacle"
        big += int(((rr - o) > 2 * res).sum())
        total += len(rr)
    assert big / total < 0.25, big / total
