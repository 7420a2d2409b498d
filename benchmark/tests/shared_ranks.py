"""One rank of the ``shared_lidar_fleet`` kind (traffic ``shared_map_x4``)
on the CPU at a small size over gloo, driven as ``benchmark/run.py``
drives a rank (join the group, set-up, the window with rank 0 deciding its
end, the gather, leaving the group, the check on rank 0), with the port's
plain versions in place of its kernels and, by ``--fault``, the timed path
broken:

* ``unpooled``: rank 1 joins each mask all-reduce but keeps its own masks;
* ``half``: half of rank 1's lanes left out of the gathered log (its
  first half sent twice);
* ``still``: every step returns its state unchanged;
* ``altered``: every speed command altered where it is produced;
* ``exit``: rank 1 exits (code 1) in its first call of the window;
* ``hang``: rank 1 stops, alive, in its first call of the window.

Started by :func:`benchmark.run.supervise`, one process a rank::

    python benchmark/tests/shared_ranks.py --rank R --world 2 --port P [--fault F] [--control]

Rank 0 prints ``run.WINDOW_MARK`` at the window's start and, last, one
JSON line: the check's numbers, each beside its limit, and (``--control``)
the control's."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

CELL = "sim_track.shared_map_x4"


def plant(fault: str, rank: int):
    """Break the timed path underneath the kind."""
    import torch

    from benchmark.tests import test_bench_control as tc
    from multi_purpose_mpc_tpu_torch import mpc, simulation
    from multi_purpose_mpc_tpu_torch.parallel import fleet as pfleet
    from multi_purpose_mpc_tpu_torch.simulation import SimResult
    from multi_purpose_mpc_tpu_torch.utils.tree import tree_map

    def unpooled(old):
        def pool(hit, free, group):
            old(hit, free, group)
            return hit, free
        return pool

    def half(old):
        def gather(res, mesh):
            def dup(axis):
                def f(x):
                    x = x.clone()
                    n = x.shape[axis]
                    idx = torch.arange(n) % max(1, n // 2)
                    return x.index_select(axis, idx)
                return f
            res = SimResult(tree_map(dup(0), res.final_state),
                            type(res.log)(*(dup(1)(x) for x in res.log)))
            return old(res, mesh)
        return gather

    faults = {"unpooled": (simulation, "pool_observation_masks", unpooled, 1),
              "half": (pfleet, "gather_fleet", half, 1),
              "still": (simulation, "drive", tc.still, None),
              "altered": (mpc, "mpc_post_solve", tc.altered, None)}
    if fault in faults:
        obj, name, fn, only = faults[fault]
        if only is None or only == rank:
            setattr(obj, name, fn(getattr(obj, name)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--fault", default="")
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    import torch

    from benchmark import drivers, run, scenario
    from benchmark.tests import cpu_cells as cc

    torch.set_num_threads(1)
    mesh = run.join(args.rank, args.world, args.port, "cpu")
    plant(args.fault, args.rank)
    cfg, tr = cc.load(CELL)
    tr["ranks"] = args.world
    d = drivers.make(scenario.configs(cfg, run.ROOT), tr, cc.SEED, "cpu")
    d.warm_up()
    if args.rank == 1 and args.fault in ("exit", "hang"):
        def call(*a, **k):
            if args.fault == "exit":
                os._exit(1)
            time.sleep(3600)
        d.call = call
    run.barrier(mesh)
    if args.rank == 0:
        print(run.WINDOW_MARK, flush=True)
    d.window(0.0)
    d.gather()
    run.leave(mesh)
    if args.rank != 0:
        return 0
    out = {}
    for key, low in (("sound", False),) + ((("control", True),)
                                           if args.control else ()):
        found, ok = cc.check(d, cfg, CELL, low=low)
        out[key] = {"ok": ok, "found": found}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
