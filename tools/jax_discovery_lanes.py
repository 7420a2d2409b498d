"""The JAX package's LiDAR discovery fleet on the CPU for given starts.

    JAX_PLATFORMS=cpu python tools/jax_discovery_lanes.py 79:0.0030268 [wp:e_y ...]

Sim_Track with its obstacles, an all-free known map, bench.py's LiDAR
(360 deg, 1 m, 4 deg per beam, 192 samples per ray), 50 steps, per-lane
maps; once with the exact "cells" scan and once with the "march" scan.
Prints each lane's max |e_y| over active steps, the step where it peaks
and the accept rate: the reference that chip_smoke.py's discovery-phase
bars are checked against (its worst lane's start is printed there).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
jax.config.update("jax_platforms", "cpu")

from multi_purpose_mpc_tpu.config import (LidarConfig, SimConfig,  # noqa: E402
                                          sim_track_preset)
from multi_purpose_mpc_tpu.ops.path import build_reference_path  # noqa: E402
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile  # noqa: E402
from multi_purpose_mpc_tpu.simulation import (init_fleet,  # noqa: E402
                                              simulate_lidar_fleet)
from multi_purpose_mpc_tpu.utils.maps import (add_obstacles_host,  # noqa: E402
                                              load_grid_map)


def main(starts):
    map_cfg, path_cfg, model, cfg, speed, obstacles = sim_track_preset(
        os.path.join(REPO, "assets", "maps"))
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed)
    # the fused solve on the card resumes the carried rho: so does this one
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, carry_rho=True))
    wp = jnp.asarray([int(s.split(":")[0]) for s in starts], jnp.int32)
    ey = jnp.asarray([float(s.split(":")[1]) for s in starts], jnp.float32)
    fleet = init_fleet(path, cfg.N, len(starts), e_y0=ey, wp_id0=wp)
    free = grid.replace(occ=jnp.ones_like(grid.occ))
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    for scan in ("cells", "march"):
        res, _ = simulate_lidar_fleet(grid, free, path, cfg, model,
                                      SimConfig(max_steps=50), lidar, fleet,
                                      scan_backend=scan,
                                      writeback_backend="scatter")
        e = np.abs(np.asarray(res.log.e_y)) * np.asarray(res.log.active)
        print(f"{scan}: starts {starts}: max|e_y| {e.max(0).tolist()} at "
              f"steps {e.argmax(0).tolist()}, accept "
              f"{np.asarray(res.log.ok).mean(0).tolist()}, failed "
              f"{np.asarray(res.final_state.failed).tolist()}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
