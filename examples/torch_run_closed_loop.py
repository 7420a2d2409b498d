"""Single-car closed-loop demo on the PyTorch port (the counterpart of
examples/run_closed_loop.py with ``--batch 1``).

Runs one of the reference scenarios end to end through
``simulation.simulate_closed_loop`` (on the card: kernels K2 and K1 every
step), prints the run's summary and renders the trajectory afterwards.

    python examples/torch_run_closed_loop.py --scenario sim_track --mode tracking
    python examples/torch_run_closed_loop.py --mode time_optimal --gif out.gif
    python examples/torch_run_closed_loop.py --device cpu --steps 20
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from multi_purpose_mpc_tpu_torch.config import (SimConfig, real_track_preset,
                                                sim_track_preset,
                                                time_optimal_config)
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.simulation import simulate_closed_loop
from multi_purpose_mpc_tpu_torch.utils.maps import add_obstacles_host, load_grid_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def summary(log, length: float) -> dict:
    """The run's summary (the JAX package's ``fleet_metrics`` for one car):
    progress, lap, acceptance, mean speed and max |e_y| over active steps."""
    active = log.active
    n = max(int(active.sum()), 1)
    return {
        "mean_progress": float(log.s[-1]) / length,
        "laps_done": float(float(log.s[-1]) >= length),
        "qp_solve_rate": int((log.ok & active).sum()) / n,
        "mean_speed": float((log.v * active).sum()) / n,
        "max_abs_e_y": float((log.e_y * active).abs().max()),
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", choices=["sim_track", "real_track"],
                   default="sim_track")
    p.add_argument("--mode", choices=["tracking", "time_optimal"],
                   default="tracking")
    p.add_argument("--obstacles", action="store_true", default=True)
    p.add_argument("--no-obstacles", dest="obstacles", action="store_false")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="mpc_trajectory.png")
    p.add_argument("--gif", default=None)
    args = p.parse_args()

    preset = sim_track_preset if args.scenario == "sim_track" else real_track_preset
    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    if not args.obstacles:
        obstacles = ()
    if args.mode == "time_optimal":
        mpc_cfg = time_optimal_config(mpc_cfg)

    grid = load_grid_map(map_cfg, device=args.device)
    path = build_reference_path(grid, path_cfg)
    if obstacles:
        grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                                  obstacles)
    path = compute_speed_profile(path, speed_cfg)
    length = float(path.length)
    print(f"[setup] {args.scenario}: {path.n_wp} waypoints, {length:.2f} m, "
          f"device={grid.device}")

    t0 = time.perf_counter()
    res = simulate_closed_loop(grid, path, mpc_cfg, model_cfg,
                               SimConfig(max_steps=args.steps))
    if grid.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    log = res.log
    n_active = int(log.active.sum())
    print(f"[run] {args.steps} steps in {dt:.2f}s ({n_active / dt:.0f} active "
          f"car-steps/s, kernel builds included)")
    for k, v in summary(log, length).items():
        print(f"  {k}: {v:.4f}")
    done_steps = log.s >= length
    if bool(done_steps.any()):
        lap_steps = int(torch.argmax(done_steps.int()))
        print(f"  lap completed at step {lap_steps} "
              f"({lap_steps * model_cfg.Ts:.2f} s sim time)")

    from multi_purpose_mpc_tpu_torch.utils.viz import (render_trajectory,
                                                       save_animation)

    render_trajectory(grid, path, obstacles, log, model_cfg, out_path=args.out)
    print(f"[viz] trajectory -> {args.out}")
    if args.gif:
        save_animation(grid, path, obstacles, log, model_cfg, args.gif)
        print(f"[viz] animation -> {args.gif}")


if __name__ == "__main__":
    main()
