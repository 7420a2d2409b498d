"""Fleet Monte-Carlo demo on the PyTorch port (the counterpart of
examples/fleet_monte_carlo.py): thousands of perturbed cars on the
obstructed track in one sharded rollout, with cross-fleet metrics,
checkpoint / resume and a multi-lane render.

Runs as one process, or as one rank per GPU under torchrun (NCCL; gloo
with ``--device cpu``): each rank rolls out its block of lanes (on the
card: kernels K2 and K1 every step), the metrics are all-reduced, and
rank 0 writes the checkpoint and the render of the gathered fleet.

    python examples/torch_fleet_monte_carlo.py --batch 1024 --steps 200
    python examples/torch_fleet_monte_carlo.py --resume
    torchrun --nproc_per_node=4 examples/torch_fleet_monte_carlo.py --batch 4096
    python examples/torch_fleet_monte_carlo.py --device cpu --batch 4 --steps 3
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from multi_purpose_mpc_tpu_torch.config import SimConfig, sim_track_preset
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.parallel.fleet import (gather_fleet,
                                                        simulate_fleet_sharded)
from multi_purpose_mpc_tpu_torch.parallel.mesh import (fleet_metrics,
                                                       global_fleet_mesh,
                                                       init_distributed,
                                                       round_up_batch)
from multi_purpose_mpc_tpu_torch.simulation import init_fleet
from multi_purpose_mpc_tpu_torch.utils.checkpoint import (load_fleet_state,
                                                          save_fleet_state)
from multi_purpose_mpc_tpu_torch.utils.maps import add_obstacles_host, load_grid_map
from multi_purpose_mpc_tpu_torch.utils.profiling import fence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default="fleet_ckpt.npz")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="fleet_trajectories.png")
    args = p.parse_args()

    init_distributed(device=args.device)
    mesh = global_fleet_mesh(args.device)
    lead = mesh.rank == 0

    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        sim_track_preset(asset_dir=os.path.join(REPO, "assets", "maps")))
    grid = load_grid_map(map_cfg, device=mesh.device)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution, obstacles)
    path = compute_speed_profile(path, speed_cfg)

    batch = round_up_batch(args.batch, mesh)
    rng = np.random.default_rng(args.seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=mesh.device)
    fleet = init_fleet(
        path, mpc_cfg.N, batch,
        e_y0=f32(rng.uniform(-0.04, 0.04, batch)),
        e_psi0=f32(rng.uniform(-0.2, 0.2, batch)),
        wp_id0=torch.tensor(rng.integers(0, path.n_wp, batch),
                            dtype=torch.int32, device=mesh.device))
    start_step = 0
    if args.resume and os.path.exists(args.checkpoint):
        fleet, start_step = load_fleet_state(args.checkpoint, like=fleet)
        if lead:
            print(f"[resume] from step {start_step}")

    if lead:
        print(f"[setup] fleet {batch} lanes over {mesh.world_size} rank(s) "
              f"on {mesh.device}")
    t0 = time.perf_counter()
    res = fence(simulate_fleet_sharded(mesh, grid, path, mpc_cfg, model_cfg,
                                       SimConfig(max_steps=args.steps), fleet))
    dt = time.perf_counter() - t0
    local = res.final_state.batch
    m = fleet_metrics(res.log, path.length, mesh)
    full = gather_fleet(res, mesh)
    if lead:
        print(f"[run] {args.steps} steps x {local} lanes a rank in {dt:.2f}s = "
              f"{local * args.steps / dt:.0f} car-steps/s a rank (kernel "
              f"builds included)")
        for k, v in m.items():
            print(f"  {k}: {float(v):.4f}")
        print(f"  lanes done: {int(full.final_state.done.sum())}/{batch}, "
              f"failed: {int(full.final_state.failed.sum())}")
        save_fleet_state(args.checkpoint, full.final_state,
                         step=start_step + args.steps)
        print(f"[ckpt] -> {args.checkpoint}")

        from multi_purpose_mpc_tpu_torch.utils.viz import render_trajectory

        render_trajectory(grid, path, obstacles, full.log, model_cfg,
                          out_path=args.out, lanes=24)
        print(f"[viz] -> {args.out}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
