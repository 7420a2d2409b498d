"""One rank of a multi-process run of the port's sharded fleets.

    python tests/torch_dist_worker.py RANK WORLD PORT SPEC OUT

:func:`launch` starts the ranks and collects their results.  Each rank
joins a gloo process group of WORLD ranks at ``localhost:PORT`` through
``parallel.mesh.init_distributed(device="cpu")`` (gloo also all-reduces
CUDA tensors, so ranks may share one card), runs the tasks of SPEC (a
``torch.save`` file written by the launcher) on this rank's lane block,
and writes what each returned, with its seconds and kernel launches, to
OUT.  Imports torch and the port only, never JAX: it runs wherever the
port does.  Used by tests/test_torch_parallel.py (CPU),
tests/test_torch_cuda.py and chip_smoke.py (the card), which import it as
``torch_dist_worker`` (the test directory on ``sys.path``); never
collected by pytest.

SPEC is a dict: ``device`` (where the lanes live), the scenario
(``grid``, ``path``, ``cfg``, ``model``, and for LiDAR tasks ``lidar``,
``known``) and ``tasks``, ``{name: dict(kind=..., ...)}`` with kinds

* ``fleet``: ``simulate_fleet_sharded`` (``sim``, ``state``), its block,
  the gathered fleet and ``fleet_metrics`` under the mesh and on the
  gathered log;
* ``lidar``: ``simulate_lidar_fleet_sharded`` (``sim``, ``state`` and its
  keyword arguments ``kw``), its block and final maps, ``fleet_metrics``;
* ``pool``: the shared-map mask pool of one scan per lane (``x``, ``y``,
  ``psi``, ``scans``, ``clear_free``) over the group, applied to
  ``known``.
"""

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# torchrun's variables: a launched rank takes its coordinates from its
# arguments alone
_RUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(spec: dict, world: int, workdir: str, timeout: float) -> list:
    """Run ``world`` ranks of this worker on ``spec`` (written into
    ``workdir``) and return each rank's results, in rank order.  Raises if
    a rank exits non-zero, with the end of its output, or if the ranks are
    not done within ``timeout`` seconds (every rank is killed first)."""
    import torch

    spec_path = os.path.join(workdir, "spec.pt")
    torch.save(spec, spec_path)
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in _RUN_ENV}
    outs = [os.path.join(workdir, f"rank{r}.pt") for r in range(world)]
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r),
                     str(world), str(port), spec_path, outs[r]],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r]) as f:
                tail = f.read()[-6000:]
            raise RuntimeError(f"rank {r} of {world} exited {p.returncode}:\n"
                               f"{tail}")
    return [torch.load(o, weights_only=False) for o in outs]


def _host(tree):
    from multi_purpose_mpc_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.detach().cpu(), tree)


def _fleet(mesh, spec, task):
    from multi_purpose_mpc_tpu_torch.parallel.fleet import (
        gather_fleet, simulate_fleet_sharded)
    from multi_purpose_mpc_tpu_torch.parallel.mesh import fleet_metrics

    res = simulate_fleet_sharded(mesh, spec["grid"], spec["path"], spec["cfg"],
                                 spec["model"], task["sim"], task["state"])
    full = gather_fleet(res, mesh)
    length = spec["path"].length.to(mesh.device)
    return dict(result=res, full=full,
                metrics=fleet_metrics(res.log, length, mesh),
                metrics_gathered=fleet_metrics(full.log, length))


def _lidar(mesh, spec, task):
    from multi_purpose_mpc_tpu_torch.parallel.fleet import (
        simulate_lidar_fleet_sharded)
    from multi_purpose_mpc_tpu_torch.parallel.mesh import fleet_metrics

    res, occ = simulate_lidar_fleet_sharded(
        mesh, spec["grid"], spec["known"], spec["path"], spec["cfg"],
        spec["model"], task["sim"], spec["lidar"], task["state"],
        **task.get("kw", {}))
    length = spec["path"].length.to(mesh.device)
    return dict(result=res, occ=occ,
                metrics=fleet_metrics(res.log, length, mesh))


def _pool(mesh, spec, task):
    from multi_purpose_mpc_tpu_torch.ops.lidar import (
        apply_observation_masks, fleet_observation_masks,
        pool_observation_masks)
    from multi_purpose_mpc_tpu_torch.parallel.mesh import (lane_block,
                                                           replicate)
    from multi_purpose_mpc_tpu_torch.utils.tree import tree_map

    known = replicate(spec["known"], mesh)
    sl = lane_block(mesh, task["x"].shape[0])
    x, y, psi, scans = tree_map(lambda t: t[sl].to(mesh.device),
                                (task["x"], task["y"], task["psi"],
                                 task["scans"]))
    h, w = known.occ.shape
    masks = fleet_observation_masks(known, h, w, x, y, psi, scans,
                                    spec["lidar"],
                                    clear_free=task["clear_free"],
                                    shared=True)
    pooled = pool_observation_masks(*masks, mesh.group)
    return dict(occ=apply_observation_masks(known.occ, *pooled),
                hitmask=pooled[0], freemask=pooled[1])


RUNNERS = {"fleet": _fleet, "lidar": _lidar, "pool": _pool}


def main(argv) -> None:
    rank, world, port = int(argv[1]), int(argv[2]), argv[3]
    spec_path, out_path = argv[4], argv[5]
    sys.path.insert(0, REPO)

    import torch
    import torch.distributed as dist

    from multi_purpose_mpc_tpu_torch.parallel.mesh import (global_fleet_mesh,
                                                           init_distributed,
                                                           lane_block)
    from multi_purpose_mpc_tpu_torch.utils.kernels import launch_counters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    if not init_distributed(f"localhost:{port}", world, rank, device="cpu"):
        raise RuntimeError("init_distributed returned False with coordinates")
    mesh = global_fleet_mesh(spec["device"])
    if (mesh.rank, mesh.world_size) != (rank, world):
        raise RuntimeError(f"mesh {mesh} for rank {rank} of {world}")
    counters = launch_counters()
    cuda = mesh.device.type == "cuda"
    out = {}
    for name, task in spec["tasks"].items():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        got = RUNNERS[task["kind"]](mesh, spec, task)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        batch = task["state"].x.shape[0] if "state" in task else task["x"].shape[0]
        sl = lane_block(mesh, batch)
        out[name] = dict(_host(got), seconds=seconds, lanes=(sl.start, sl.stop),
                         launches={k: getattr(fn, attr)
                                   for k, (fn, attr) in counters.items()})
    torch.save(out, out_path)
    dist.destroy_process_group()
    print(f"rank {rank} of {world}: {', '.join(spec['tasks'])} done",
          flush=True)


if __name__ == "__main__":
    main(sys.argv)
