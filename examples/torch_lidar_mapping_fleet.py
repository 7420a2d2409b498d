"""LiDAR-in-the-loop mapping fleet on the PyTorch port (the counterpart of
examples/lidar_mapping_fleet.py).

A fleet of cars starts on the Sim_Track with an optimistic map (all free);
each lane scans the true world every control step, writes the hits into
its own working map (or one shared, cooperatively built map with
``--shared``), and the MPC corridor is extracted from that evolving map.
With ``--sharded`` the lanes (and their maps) are split over the ranks
(torchrun); with ``--shared`` too, the ranks pool the map's observation
masks with one all-reduce per mask class every step.

    python examples/torch_lidar_mapping_fleet.py [--batch 64] [--steps 120]
                                                 [--shared] [--out map.png]
    torchrun --nproc_per_node=4 examples/torch_lidar_mapping_fleet.py \\
        --sharded --shared
    python examples/torch_lidar_mapping_fleet.py --device cpu --batch 4 --steps 2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from multi_purpose_mpc_tpu_torch.config import (LidarConfig, SimConfig,
                                                sim_track_preset)
from multi_purpose_mpc_tpu_torch.ops.grid import make_grid_map
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.parallel.fleet import (
    gather_fleet, simulate_lidar_fleet_sharded)
from multi_purpose_mpc_tpu_torch.parallel.mesh import (global_fleet_mesh,
                                                       init_distributed,
                                                       round_up_batch)
from multi_purpose_mpc_tpu_torch.simulation import (init_fleet,
                                                    simulate_lidar_fleet)
from multi_purpose_mpc_tpu_torch.utils.maps import add_obstacles_host, load_grid_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--shared", action="store_true",
                    help="one cooperatively-built map instead of per-lane")
    ap.add_argument("--scan-backend", default="auto",
                    choices=["auto", "march", "cells"],
                    help="march = point-sampled ray march; cells = exact "
                         "corner-span sweep (the card's default)")
    ap.add_argument("--sharded", action="store_true",
                    help="split lanes (and their maps) over the ranks via "
                         "parallel.fleet.simulate_lidar_fleet_sharded; with "
                         "--shared the map is pooled over the ranks by "
                         "per-step all-reduces")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="lidar_fleet_map.png")
    args = ap.parse_args()

    if args.sharded:
        init_distributed(device=args.device)
    mesh = global_fleet_mesh(args.device)
    dev = mesh.device

    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        sim_track_preset(asset_dir=os.path.join(REPO, "assets", "maps")))
    true_grid = load_grid_map(map_cfg, device=dev)
    path = build_reference_path(true_grid, path_cfg)
    true_grid = add_obstacles_host(true_grid, map_cfg.origin,
                                   map_cfg.resolution, obstacles)
    path = compute_speed_profile(path, speed_cfg)

    known0 = make_grid_map(torch.ones_like(true_grid.occ), map_cfg.origin,
                           map_cfg.resolution, device=dev)
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)

    batch = round_up_batch(args.batch, mesh)
    rng = np.random.default_rng(0)
    fleet0 = init_fleet(path, mpc_cfg.N, batch,
                        wp_id0=torch.tensor(rng.integers(0, path.n_wp, batch),
                                            dtype=torch.int32, device=dev))
    sim = SimConfig(max_steps=args.steps, static_grid=False)

    if args.sharded:
        res, occ = simulate_lidar_fleet_sharded(
            mesh, true_grid, known0, path, mpc_cfg, model_cfg, sim, lidar,
            fleet0, shared_grid=args.shared, scan_backend=args.scan_backend)
        res = gather_fleet(res, mesh)
    else:
        res, occ = simulate_lidar_fleet(
            true_grid, known0, path, mpc_cfg, model_cfg, sim, lidar, fleet0,
            shared_grid=args.shared, scan_backend=args.scan_backend)

    if mesh.rank == 0:
        act = res.log.active
        print(f"batch {batch} over {mesh.world_size} rank(s), {args.steps} "
              f"steps, accept rate {float(res.log.ok[act].float().mean()):.3f}, "
              f"failed lanes {int(res.final_state.failed.sum())}")
        # lane 0 lives on rank 0
        occ = (occ if args.shared else occ[0]).cpu().numpy()
        discovered = int((known0.occ.cpu().numpy() - occ).sum())
        print(f"{'shared' if args.shared else 'lane-0'} map: "
              f"{discovered} occupied cells discovered")
        plot(true_grid, path, occ, args.shared, args.out)
        print(f"wrote {args.out}")
    if dist.is_initialized():
        dist.destroy_process_group()


def plot(true_grid, path, occ, shared: bool, out: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    origin = true_grid.origin.cpu().numpy()
    res = float(true_grid.resolution)
    px = (path.x.cpu().numpy() - origin[0]) / res
    py = (path.y.cpu().numpy() - origin[1]) / res
    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    for ax, (g, title) in zip(axes, [
            (true_grid.occ.cpu().numpy(), "true world"),
            (occ, "discovered map" + (" (shared)" if shared else " (lane 0)"))]):
        ax.imshow(g, cmap="gray", origin="lower")
        ax.plot(px, py, lw=0.5, c="tab:blue")
        ax.set_title(title)
        ax.set_axis_off()
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    main()
