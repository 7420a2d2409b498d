"""The sharded fleets over K ranks, each rank's block held against the same
lanes of one process's run, bit for bit.

    torchrun --nproc_per_node=4 tools/sharded_fleet_check.py          # NCCL, a GPU a rank
    torchrun --nproc_per_node=4 tools/sharded_fleet_check.py --device cpu \\
        --batch 8 --lidar-batch 8 --steps 3                             # gloo

Every rank builds the Sim_Track scenario (``chip_smoke.py``'s seed for the
starts) and runs, through ``parallel.fleet``:

* the static fleet (``--batch`` lanes): ``simulate_fleet_sharded``;
* the per-lane discovery fleet from an all-free known map
  (``--lidar-batch`` lanes; on the card the maps bit-packed, kernel K6);
* the shared-grid fleet with ``clear_free`` (``--lidar-batch`` lanes,
  dense write-back): one map, its observation masks pooled over the ranks
  by one MAX all-reduce per mask class a step;

each for ``--steps`` steps after the same fleet unsharded on its own
device (on the card rank 0 builds the six kernels first, every rank loads
them, and one step of each fleet warms the rank up before anything is
timed), and checks that its block's logs, final state and maps equal the
unsharded run's lanes bit for bit, that the shared map is the unsharded
one, that ``gather_fleet`` gives the unsharded static fleet and that
``fleet_metrics`` under the mesh equals the unsharded values.  Prints a
line per fleet with each rank's car-steps/s (its own sharded rollout,
started together after a barrier and synchronised: the whole call, the
CUDA-graph capture included; on the card the capture's seconds and the
rate of the replays alone beside it) and rank 0's unsharded run of the
whole fleet on its one card, and the card's name and power limit; exits
non-zero on any mismatch.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multi_purpose_mpc_tpu_torch.config import (LidarConfig, SimConfig,  # noqa: E402
                                                sim_track_preset)
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile  # noqa: E402
from multi_purpose_mpc_tpu_torch.parallel.fleet import (  # noqa: E402
    gather_fleet, simulate_fleet_sharded, simulate_lidar_fleet_sharded)
from multi_purpose_mpc_tpu_torch.parallel.mesh import (  # noqa: E402
    fleet_metrics, global_fleet_mesh, init_distributed, lane_block)
from multi_purpose_mpc_tpu_torch.simulation import (  # noqa: E402
    feasible_starts, init_fleet, simulate_fleet, simulate_lidar_fleet)
from multi_purpose_mpc_tpu_torch.utils import kernels  # noqa: E402
from multi_purpose_mpc_tpu_torch.utils.profiling import capture_seconds  # noqa: E402
from multi_purpose_mpc_tpu_torch.utils.maps import (  # noqa: E402
    add_obstacles_host, load_grid_map)
from multi_purpose_mpc_tpu_torch.utils.tree import leaves, tree_map  # noqa: E402

SEED = 20261016  # chip_smoke.py's


def card() -> str:
    if not torch.cuda.is_available():
        return "CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def same(a, b, label):
    """Raise unless two trees hold the same leaves bit for bit."""
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b))):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{label}: leaf {i} differs")


def timed(fn, cuda: bool, group):
    """``(fn(), seconds, capture seconds, replay seconds)``: the wall of
    the call, the part of it its CUDA-graph captures took, and what is
    left once the first step (the graphs' warm-up) is taken out too (on
    the CPU 0 and the wall)."""
    if not cuda:
        dist.barrier(group=group)
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        return out, wall, 0.0, wall
    torch.cuda.synchronize()
    dist.barrier(group=group)
    t0 = time.perf_counter()
    with capture_seconds() as caps:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cap = sum(c for _, c in caps)
    return out, wall, cap, wall - cap - sum(w for w, _ in caps)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--lidar-batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=50)
    args = p.parse_args()

    if not init_distributed(device=args.device):
        raise SystemExit("run under torchrun: no process group coordinates")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = global_fleet_mesh(args.device)
    cuda = mesh.device.type == "cuda"
    dev, lead = mesh.device, mesh.rank == 0
    if cuda:
        names = [p.stem for p in kernels.SRC_DIR.glob("*.cu")]
        if lead:
            kernels.build_all(names)
        dist.barrier(group=mesh.group)
        for name in names:
            kernels.load(name)

    map_cfg, path_cfg, model, cfg, speed_cfg, obstacles = sim_track_preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    grid = load_grid_map(map_cfg, device=dev)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution, obstacles)
    path = compute_speed_profile(path, speed_cfg)
    wp0, ey0 = feasible_starts(grid, path, cfg, model, args.batch,
                               np.random.default_rng(SEED))
    fleet = init_fleet(path, cfg.N, args.batch, e_y0=ey0, wp_id0=wp0)
    nl = args.lidar_batch
    lfleet = init_fleet(path, cfg.N, nl, e_y0=ey0[:nl], wp_id0=wp0[:nl])
    free = dataclasses.replace(grid, occ=torch.ones_like(grid.occ))
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    static_sim = SimConfig(max_steps=args.steps)
    dyn_sim = SimConfig(max_steps=args.steps, static_grid=False)
    lines = []

    def report(label, nb, secs, ref_secs):
        """``secs`` / ``ref_secs``: :func:`timed`'s (wall, capture,
        replays)."""
        graphed = secs[1] > 0  # the rollout replayed graphs
        steps = args.steps - graphed  # the replayed steps
        lanes = nb // mesh.world_size
        rates = torch.tensor([lanes * args.steps / secs[0], secs[1],
                              lanes * steps / secs[2]],
                             dtype=torch.float64, device=dev)
        every = [torch.empty_like(rates) for _ in range(mesh.world_size)]
        dist.all_gather(every, rates, group=mesh.group)
        ref = nb * args.steps / ref_secs[0]
        ref_replay = nb * steps / ref_secs[2]
        lines.append(f"[sharded] {label}, B={nb} x {args.steps} steps over "
                     f"{mesh.world_size} ranks ({dist.get_backend()}): "
                     f"bitwise equal to one process's lanes; car-steps/s a "
                     f"rank, the whole call "
                     + ", ".join(f"{float(r[0]):.1f}" for r in every)
                     + f", together {sum(float(r[0]) for r in every):.1f}; "
                     f"the replays alone "
                     + ", ".join(f"{float(r[2]):.1f}" for r in every)
                     + f"; capture s a rank "
                     + ", ".join(f"{float(r[1]):.3f}" for r in every)
                     + f"; unsharded on one card {ref:.1f} (replays "
                     f"{ref_replay:.1f}, capture {ref_secs[1]:.3f} s)")

    simulate_fleet(grid, path, cfg, model, SimConfig(max_steps=1), fleet)
    for kw in ({}, dict(shared_grid=True, clear_free=True)):
        simulate_lidar_fleet(grid, free, path, cfg, model,
                             SimConfig(max_steps=1, static_grid=False), lidar,
                             lfleet, **kw)

    # the static fleet
    ref, *ref_secs = timed(lambda: simulate_fleet(
        grid, path, cfg, model, static_sim, fleet), cuda, mesh.group)
    res, *secs = timed(lambda: simulate_fleet_sharded(
        mesh, grid, path, cfg, model, static_sim, fleet), cuda, mesh.group)
    metrics = fleet_metrics(res.log, path.length, mesh)
    full = gather_fleet(res, mesh)
    sl = lane_block(mesh, args.batch)
    same(res.log, type(ref.log)(*(f[:, sl] for f in ref.log)), "static log")
    same(res.final_state, tree_map(lambda x: x[sl], ref.final_state),
         "static final state")
    same(full, ref, "gathered static fleet")
    ref_m = fleet_metrics(ref.log, path.length)
    if not torch.equal(metrics["max_abs_e_y"], ref_m["max_abs_e_y"]) or any(
            bool((metrics[k] - v).abs() > 1e-6 * v.abs())
            for k, v in ref_m.items()):
        raise AssertionError(f"fleet_metrics {metrics} vs {ref_m}")
    report("static fleet", args.batch, secs, ref_secs)

    # the per-lane discovery fleet, then the shared-grid fleet
    sl = lane_block(mesh, nl)
    for label, kw in (("per-lane discovery fleet", {}),
                      ("shared-grid fleet, clear_free",
                       dict(shared_grid=True, clear_free=True))):
        (ref, ref_occ), *ref_secs = timed(lambda: simulate_lidar_fleet(
            grid, free, path, cfg, model, dyn_sim, lidar, lfleet, **kw), cuda,
            mesh.group)
        (res, occ), *secs = timed(lambda: simulate_lidar_fleet_sharded(
            mesh, grid, free, path, cfg, model, dyn_sim, lidar, lfleet, **kw),
            cuda, mesh.group)
        same(res.log, type(ref.log)(*(f[:, sl] for f in ref.log)),
             f"{label} log")
        same(res.final_state, tree_map(lambda x: x[sl], ref.final_state),
             f"{label} final state")
        same(occ, ref_occ if kw else ref_occ[sl], f"{label} maps")
        report(label, nl, secs, ref_secs)

    dist.barrier(group=mesh.group)
    if lead:
        for line in lines:
            print(f"{line} on {card()}", flush=True)
        print("sharded fleet check: ok", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
