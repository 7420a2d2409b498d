"""One rank of the four-card shared-map LiDAR fleet (the benchmark's
``shared_lidar_fleet`` kind, traffic ``shared_map_x4``) on the CPU at a
small size over gloo: the port's
``parallel.fleet.simulate_lidar_fleet_sharded(shared_grid=True,
clear_free=True)``, its plain versions in place of its kernels, for two
calls; then the gather and, on rank 0, the benchmark's check against the
plain float64 reference (``benchmark/reference/shared.py`` rebuilds the
shared map at every step from all lanes' logged poses).

``--fault unpooled``: rank 1 joins each mask all-reduce but keeps its own
masks.

Started by :func:`benchmark.run.supervise`, one process a rank::

    python tests/shared_map_ranks.py --rank R --world 2 --port P [--fault unpooled]

Rank 0 prints, last, one JSON line: the check's numbers, each beside its
limit, whether all hold, the uint8 all-reduces the two calls made and the
bytes they pooled (``torch.distributed.all_reduce`` watched), and the
calls' steps."""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "sim_track.shared_map_x4"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)

    import torch

    from benchmark import drivers, run, scenario
    from benchmark.tests import cpu_cells as cc
    import torch.distributed as dist

    from multi_purpose_mpc_tpu_torch import simulation

    torch.set_num_threads(1)
    mesh = run.join(args.rank, args.world, args.port, "cpu")
    if args.fault == "unpooled" and args.rank == 1:
        pool = simulation.pool_observation_masks

        def unpooled(hit, free, group):
            pool(hit, free, group)
            return hit, free

        simulation.pool_observation_masks = unpooled
    cfg, tr = cc.load(CELL)
    tr["ranks"] = args.world
    d = drivers.make(scenario.configs(cfg, run.ROOT), tr, cc.SEED, "cpu")
    counts = {"mask_all_reduces": 0, "mask_pool_bytes": 0}
    all_reduce = dist.all_reduce

    def watched(tensor, *a, **kw):
        if tensor.dtype == torch.uint8:  # the masks; nothing else is uint8
            counts["mask_all_reduces"] += 1
            counts["mask_pool_bytes"] += tensor.numel()
        return all_reduce(tensor, *a, **kw)

    dist.all_reduce = watched
    d.warm_up()  # two calls
    dist.all_reduce = all_reduce
    d.gather()
    run.leave(mesh)
    if args.rank != 0:
        return 0
    found, ok = cc.check(d, cfg, CELL)
    print(json.dumps({"ok": ok, "found": found, "counts": counts,
                      "steps": 2 * d.T,
                      "map_cells": int(d.known.occ.numel())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
