"""The JAX package's own laps of tests/test_modes.py with its TPU kernels'
semantics, on the CPU, beside its XLA solver's.

    JAX_PLATFORMS=cpu python tools/jax_mode_laps.py [T] [BACKEND ...]   # 400 pallas xla

Runs ``simulate_closed_loop`` of the JAX package on tests/test_modes.py's
world (Sim_Track with its obstacles, the preset's speed profile) for the
tracking and the time-optimal (``time_optimal_config``) configs, with
``solver_backend="pallas"`` — the fused TPU kernel, which resumes the
carried rho, and the corridor kernel, both in interpret mode (~10 min a
lap) — and ``"xla"``, the solver tests/test_modes.py runs on the CPU,
which restarts from ``cfg.rho``.  Prints each lap's length, mean speed
over the active steps, max |e_y| and accept rate.  Imports JAX: a tool
for the parity record, not part of the port.
"""

import dataclasses
import functools
import os
import sys
import time

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
jax.config.update("jax_platforms", "cpu")

from multi_purpose_mpc_tpu.config import (SimConfig, sim_track_preset,  # noqa: E402
                                          time_optimal_config)
from multi_purpose_mpc_tpu.ops import admm_pallas, corridor_pallas  # noqa: E402
from multi_purpose_mpc_tpu.ops.path import build_reference_path  # noqa: E402
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile  # noqa: E402
from multi_purpose_mpc_tpu.simulation import simulate_closed_loop  # noqa: E402
from multi_purpose_mpc_tpu.utils.maps import (add_obstacles_host,  # noqa: E402
                                              load_grid_map)

# the kernels in interpret mode: the mpc step imports them at call time
admm_pallas.solve_mpc_qp_fused = functools.partial(
    admm_pallas.solve_mpc_qp_fused, interpret=True)
corridor_pallas.corridor_select_pallas = functools.partial(
    corridor_pallas.corridor_select_pallas, interpret=True)


def main(T=400, backends=("pallas", "xla")):
    map_cfg, path_cfg, model, cfg, speed_cfg, obstacles = sim_track_preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed_cfg)
    length = float(path.length)
    for name, c in (("tracking", cfg), ("time_optimal", time_optimal_config(cfg))):
        for backend in backends:
            t0 = time.time()
            r = simulate_closed_loop(
                grid, path, dataclasses.replace(c, solver_backend=backend),
                model, SimConfig(max_steps=T))
            s, act = np.asarray(r.log.s), np.asarray(r.log.active)
            lap = int(np.argmax(s >= length)) if (s >= length).any() else -1
            print(f"{name}, {backend}: lap {lap} steps, done "
                  f"{bool(r.final_state.done)}, mean v "
                  f"{np.asarray(r.log.v)[act].mean():.4f}, max |e_y| "
                  f"{np.abs(np.asarray(r.log.e_y)[act]).max():.4f}, accept "
                  f"{np.asarray(r.log.ok)[act].mean():.4f}, "
                  f"{time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[0]) if args else 400, tuple(args[1:]) or ("pallas", "xla"))
