"""Controller-tuning sweep on the PyTorch port (the counterpart of
examples/weight_sweep.py): one batched rollout, every lane a differently
weighted MPC.

Tracking, time-optimal driving and obstacle avoidance are weight choices
on one QP, so a whole tuning grid — Q_ey x R_v x terminal-time weight —
runs as one fleet with per-lane weights (``WeightSet``; on the card the
per-lane QPs are solved by kernel K3) and is scored in a single rollout.
Under torchrun each rank takes a block of the grid's lanes (the lane
count must divide by the ranks) and rank 0 scores the gathered fleet.

    python examples/torch_weight_sweep.py --steps 300
    torchrun --nproc_per_node=4 examples/torch_weight_sweep.py
    python examples/torch_weight_sweep.py --device cpu --repeats 1 --steps 3
"""

import argparse
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from multi_purpose_mpc_tpu_torch.config import SimConfig, sim_track_preset
from multi_purpose_mpc_tpu_torch.mpc import WeightSet
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.parallel.fleet import gather_fleet
from multi_purpose_mpc_tpu_torch.parallel.mesh import (global_fleet_mesh,
                                                       init_distributed,
                                                       shard_fleet_state)
from multi_purpose_mpc_tpu_torch.simulation import init_fleet, simulate_fleet
from multi_purpose_mpc_tpu_torch.utils.maps import add_obstacles_host, load_grid_map
from multi_purpose_mpc_tpu_torch.utils.profiling import fence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--repeats", type=int, default=4,
                   help="perturbed starts per weight config (Monte-Carlo)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    init_distributed(device=args.device)
    mesh = global_fleet_mesh(args.device)
    dev = mesh.device

    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        sim_track_preset(asset_dir=os.path.join(REPO, "assets", "maps")))
    grid = load_grid_map(map_cfg, device=dev)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed_cfg)

    # tuning grid: tracking weight x speed-tracking weight x time weight
    q_ey_grid = (0.5, 1.0, 2.0, 5.0)
    r_v_grid = (0.01, 0.1, 0.5)
    t_w_grid = (0.0, 10.0, 100.0)
    combos = list(itertools.product(q_ey_grid, r_v_grid, t_w_grid))
    B = len(combos) * args.repeats
    rows = combos * args.repeats
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    ws = WeightSet(Q=f32([[q, 0.0, 0.0] for q, _, _ in rows]),
                   R=f32([[r, 0.0] for _, r, _ in rows]),
                   QN=f32([[q, 0.0, tw] for q, _, tw in rows]))

    rng = np.random.default_rng(0)
    fleet = init_fleet(path, mpc_cfg.N, B,
                       e_y0=f32(rng.uniform(-0.03, 0.03, B)))

    if mesh.rank == 0:
        print(f"[setup] {len(combos)} weight configs x {args.repeats} starts "
              f"= {B} lanes over {mesh.world_size} rank(s) on {dev}")
    t0 = time.perf_counter()
    res = fence(simulate_fleet(grid, path, mpc_cfg, model_cfg,
                               SimConfig(max_steps=args.steps),
                               shard_fleet_state(fleet, mesh),
                               weights=shard_fleet_state(ws, mesh)))
    dt = time.perf_counter() - t0
    res = gather_fleet(res, mesh)
    if mesh.rank == 0:
        print(f"[run] {args.steps} steps x {B} lanes in {dt:.2f}s "
              f"(kernel builds included)")
        score(res, combos, args.repeats, args.steps, float(path.length))
    if dist.is_initialized():
        dist.destroy_process_group()


def score(res, combos, repeats: int, steps: int, length: float) -> None:
    """Print each config's lap completion steps (lower = faster), mean
    |e_y| and failed lanes, best first."""
    s_log = res.log.s.cpu().numpy()  # (T, B)
    e_y = np.abs(res.log.e_y.cpu().numpy())
    act = res.log.active.cpu().numpy()
    failed = res.final_state.failed.cpu().numpy()
    done = s_log >= length
    lap = np.where(done.any(0), done.argmax(0), steps)  # (B,)

    K = len(combos)
    lap_c = lap.reshape(repeats, K).mean(0)
    # a config whose lanes all fail at once has no active step: score it
    # inf so it sorts last
    ey_c = np.array([e_y[:, i::K][act[:, i::K]].mean()
                     if act[:, i::K].any() else np.inf for i in range(K)])
    fail_c = failed.reshape(repeats, K).sum(0)

    print(f"{'Q_ey':>6} {'R_v':>6} {'t_w':>6} | {'lap steps':>9} "
          f"{'mean|e_y|':>9} {'failed':>6}")
    order = np.lexsort((ey_c, lap_c))
    for i in order:
        q, r, tw = combos[i]
        print(f"{q:6.2f} {r:6.2f} {tw:6.1f} | {lap_c[i]:9.1f} "
              f"{ey_c[i]:9.4f} {int(fail_c[i]):6d}")
    best = order[0]
    print(f"[best] Q_ey={combos[best][0]}, R_v={combos[best][1]}, "
          f"t_weight={combos[best][2]} -> {lap_c[best]:.0f} steps, "
          f"mean |e_y| {ey_c[best]:.4f} m")


if __name__ == "__main__":
    main()
