"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose kind
``benchmark/kinds/<kind>.py`` drives it).
Set-up builds the port's kernels (cached in
``multi_purpose_mpc_tpu_torch/_build/`` inside the checkout), loads the
scenario, draws the inputs from the seed and makes the first call, which
captures the CUDA graphs.  ``--trace 0`` then measures ``--seconds`` of
calls and prints the cell's end-to-end metrics; ``--trace 1`` measures the
same window, traces a few more calls with torch.profiler and prints its
per-layer metrics (``benchmark/metrics/<name>.py``).  Either way the
window's last call is then checked against the plain reference
(:mod:`benchmark.checks`).  Fails, printing no result, without enough
CUDA devices, or if JAX or the JAX package was loaded.

A cell on more than one card (``chips`` in ``BENCHMARK.json``) is run by
its ranks: this command starts the same command once a card with the
rank's hidden arguments (:func:`launch`), watches them, and prints rank
0's result once every rank has ended well.  The ranks join one NCCL
process group (rank 0 builds the kernels first, the others load them),
run the same set-up and the same calls; rank 0 decides when the window
ends, reads the per-layer metrics from its trace and checks the gathered
last call.  If a rank fails, or the ranks outlive their deadline
(``SETUP_LIMIT_S`` to reach the window, then ``GRACE_S`` past its end),
every rank is killed and the command fails with no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import datetime  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_purpose_mpc_tpu")
# every kernel a cell launches, built and loaded in set-up (of several
# ranks: built by rank 0 alone, then loaded by each)
KERNELS = ("corridor_select", "admm_fused", "admm_structured", "extract_occ",
           "writeback_extract", "writeback_extract_packed", "scan_cells",
           "free_runs", "stage_clock")
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# a rank tells the launcher on its standard output that the window starts
WINDOW_MARK = "#window"
SETUP_LIMIT_S = 1100.0  # launch to the window (a fresh checkout compiles)
GRACE_S = 120.0  # past the window's end: traced calls, gather, the check
# how long an eager collective waits: the ranks wait at a barrier while
# rank 0 builds the kernels
GROUP_TIMEOUT_S = 600.0


class Fail(Exception):
    """A run that prints no result: the message goes to standard error."""


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise Fail(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def for_cell(metrics, cell: str):
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``read`` of ``benchmark/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def hand_kernels() -> dict:
    """``{id: symbol}`` of ``benchmark/kernels/<id>.json``."""
    d = os.path.join(HERE, "kernels")
    return {f[:-5]: load_json(os.path.join(d, f))["symbol"]
            for f in sorted(os.listdir(d)) if f.endswith(".json")}


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads (see ``benchmark/metrics``)."""

    trace: object  # benchmark.trace.DeviceTrace of the traced calls
    steps: int  # fleet steps (or API cycles) in the traced calls
    window: object  # benchmark.drivers.Window of the measured window
    capture: list  # [(warm-up s, capture s)] of the first call's graphs
    shapes: dict
    peaks: dict
    kernels: dict  # {id: symbol}
    k7_in_range: object = None  # (in-range cells summed over scans, scans)

    def is_kernel(self, kid: str):
        sym = self.kernels[kid]
        return lambda name: sym in name

    def is_hand_kernel(self, name: str) -> bool:
        return any(sym in name for sym in self.kernels.values())


def info(**kv) -> None:
    """A line of diagnostics on standard error (not part of the result)."""
    print("info " + json.dumps(kv, default=str), file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def gpu_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def cards(cell: dict) -> None:
    """Fail unless this machine has the CUDA devices that ``cell`` asks
    for."""
    import torch

    if not torch.cuda.is_available():
        raise Fail("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        raise Fail(f"{cell['name']} needs {cell['chips']} CUDA devices, "
                   f"{torch.cuda.device_count()} found")


def run(args) -> dict:
    manifest = load_json(MANIFEST)
    cell = find(manifest["workloads"], args.workload, "workload")
    conf = find(manifest["configs"], cell["config"], "configuration")
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))

    import torch

    cards(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # one process, few threads: a steadier host
    sys.path.insert(0, ROOT)
    return measure(args, manifest, cell, cfg, traffic)


def measure(args, manifest, cell, cfg, traffic):
    """Set-up, the window, the traced calls and the check of one run; of a
    cell on several cards, one rank's part (rank 0 returns the result, the
    others None)."""
    import torch

    from benchmark import checks, drivers, scenario
    from benchmark import trace as tracing
    from multi_purpose_mpc_tpu_torch.utils import graphs, kernels

    marks = [("imports", time.perf_counter())]
    mesh = (None if args.rank is None
            else join(args.rank, cell["chips"], args.port, "cuda"))
    lead = mesh is None or mesh.rank == 0
    if lead:  # the other ranks load what rank 0 built
        kernels.build_all(KERNELS)
    if mesh is not None:
        barrier(mesh)
    for name in KERNELS:
        kernels.load(name)
    marks.append(("kernels", time.perf_counter()))
    sc = scenario.configs(cfg, ROOT)
    driver = drivers.make(sc, traffic, args.seed, "cuda")
    marks.append(("scenario and inputs", time.perf_counter()))
    with graphs.capture_seconds() as caps:
        driver.warm_up()
    torch.cuda.synchronize()
    if mesh is not None:
        barrier(mesh)
    marks.append(("first calls", time.perf_counter()))
    # of several ranks: from the launcher's start to the end of every
    # rank's first calls (both clocks are CLOCK_MONOTONIC)
    setup_s = (time.perf_counter() - T_START if mesh is None
               else time.monotonic() - args.t0)
    if lead:
        info(setup=" ".join(f"{k} {b - a:.3f} s" for (_, a), (k, b) in zip(
            [("start", T_START)] + marks[:-1], marks)))
    if mesh is not None and lead:
        print(WINDOW_MARK, flush=True)

    win = driver.window(args.seconds)
    e2e = {m["name"]: m for m in for_cell(manifest["end_to_end"], cell["name"])}
    metrics = {}
    if not args.trace:
        values = {"setup_s": setup_s,
                  "car_steps_per_s": win.work / win.seconds,
                  "accept_rate": 100.0 * win.accepted / max(win.active, 1)}
        if win.cycle_s:
            import numpy as np
            values["control_ms_p95"] = 1e3 * float(np.percentile(win.cycle_s, 95))
        for name, m in e2e.items():
            metrics[name] = {"value": values[name], "unit": m["unit"]}
    else:
        n = traffic["traced_calls"]
        dtrace = tracing.traced(driver.traced_calls(n))
        k7 = getattr(driver, "k7_in_range", None)
        ctx = Context(trace=dtrace, steps=n * driver.T, window=win,
                      capture=list(caps), shapes=driver.shapes(),
                      peaks=load_json(os.path.join(HERE, "peaks.json")),
                      kernels=hand_kernels(),
                      k7_in_range=k7() if k7 is not None and lead else None)
        for m in for_cell(manifest["per_layer"], cell["name"]) if lead else ():
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    torch.cuda.synchronize()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if args.trace:
        device.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
    if mesh is not None:
        device.update(over_ranks(mesh, device))
        driver.gather()
        leave(mesh)
        if not lead:
            return None
    t0 = time.perf_counter()
    found = checks.check(driver, cfg, ROOT, args.seed, cell["name"])
    info(reference_s=time.perf_counter() - t0, window_s=win.seconds,
         calls=win.calls, **getattr(driver, "check_info", {}))
    found = {k: (v if math.isfinite(v) else sys.float_info.max, lim)
             for k, (v, lim) in found.items()}
    correct = bool(found) and all(v <= lim for v, lim in found.values())
    return result(correct, win.calls * driver.B, driver.failed, metrics,
                  device, ({"device_ops": dtrace.top(10),
                            "idle_gaps": dtrace.idle_gaps[:10]}
                           if args.trace else None), found)


def join(rank: int, world: int, port: int, device):
    """This process's place among a cell's ranks: the process group over
    ``127.0.0.1:port`` (NCCL on the card, a card a rank; gloo on the CPU),
    as ``parallel.mesh.init_distributed`` joins it, with the timeout
    ``GROUP_TIMEOUT_S`` that it does not take; then the fleet mesh."""
    import torch
    import torch.distributed as dist

    from multi_purpose_mpc_tpu_torch.parallel.mesh import global_fleet_mesh

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return global_fleet_mesh(device)


def barrier(mesh) -> None:
    import torch.distributed as dist

    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    dist.barrier(group=mesh.group, device_ids=ids)


def leave(mesh) -> None:
    """Free the cached graphs (they hold the communicator), then leave the
    process group together."""
    import torch.distributed as dist

    from multi_purpose_mpc_tpu_torch.utils import graphs

    graphs.clear_cache()
    barrier(mesh)
    dist.destroy_process_group()


def over_ranks(mesh, device: dict) -> dict:
    """``device``'s memory peak of the fullest card, and its traced busy
    and window seconds averaged over the cards."""
    import torch
    import torch.distributed as dist

    keys = [k for k in ("memory_peak_bytes", "busy_s", "window_s")
            if k in device]
    mine = torch.tensor([float(device[k]) for k in keys], dtype=torch.float64,
                        device=mesh.device)
    every = [torch.empty_like(mine) for _ in range(mesh.world_size)]
    dist.all_gather(every, mine, group=mesh.group)
    every = torch.stack(every)
    out = {k: float(every[:, i].mean()) for i, k in enumerate(keys)}
    out["memory_peak_bytes"] = int(every[:, 0].max())
    return out


def result(correct, attempted, failed, metrics, device, breakdown,
           found) -> dict:
    """The result line's object; the numbers compared, each beside its
    limit, under the last key."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["card"] = gpu_line()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in found.items()}
    return out


def launch(args, chips: int) -> dict:
    """Run a cell's ``chips`` ranks, one process a card, each this command
    with its rank, the process group's port and the launcher's start, and
    return rank 0's result (:func:`supervise`)."""
    t0 = time.monotonic() - (time.perf_counter() - T_START)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, os.path.abspath(__file__), "--workload",
           args.workload, "--seed", str(args.seed), "--seconds",
           repr(args.seconds), "--trace", str(args.trace), "--port",
           str(port), "--t0", repr(t0)]
    return supervise([cmd + ["--rank", str(r)] for r in range(chips)],
                     args.seconds)


def die_with_parent() -> None:
    """In a rank's process before it starts: the kernel kills it when its
    launcher dies, however the launcher ends (Linux ``PR_SET_PDEATHSIG``)."""
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)


def supervise(cmds, seconds: float, setup_limit: float = SETUP_LIMIT_S,
              grace: float = GRACE_S) -> dict:
    """Start the ranks' commands (rank r's at index r), each killed with
    this process (:func:`die_with_parent`), and return the object on rank
    0's last line of standard output once every rank has exited with 0.  As soon as one exits
    otherwise, or the ranks outlive their deadline (``setup_limit`` from
    the start until rank 0 prints ``WINDOW_MARK``, then ``seconds`` +
    ``grace`` from the mark), or this process gets SIGTERM or SIGINT,
    every rank is killed and :class:`Fail` raised."""
    procs, lines, marks = [], [], []

    def read(pipe):
        for line in pipe:
            (marks if line.startswith(WINDOW_MARK) else lines).append(
                (time.monotonic(), line))

    def stop(signum, _):
        raise Fail(f"stopped by signal {signum}; every rank killed")

    old = {sig: signal.signal(sig, stop)
           for sig in (signal.SIGTERM, signal.SIGINT)}
    start = time.monotonic()
    try:
        for r, cmd in enumerate(cmds):
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
                text=True, preexec_fn=die_with_parent))
        pipe = threading.Thread(target=read, args=(procs[0].stdout,),
                                daemon=True)
        pipe.start()
        while True:
            codes = [p.poll() for p in procs]
            for r, code in enumerate(codes):
                if code not in (None, 0):
                    raise Fail(f"rank {r} exited with code {code}; every "
                               "rank killed")
            if None not in codes:
                break
            deadline = (marks[0][0] + seconds + grace if marks
                        else start + setup_limit)
            if time.monotonic() > deadline:
                raise Fail("the ranks outlived their deadline "
                           f"({'past the window' if marks else 'before it'})"
                           "; every rank killed")
            time.sleep(0.05)
        pipe.join()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for sig, handler in old.items():
            signal.signal(sig, handler)
    try:
        return json.loads(lines[-1][1])
    except (IndexError, ValueError):
        raise Fail("rank 0 printed no result") from None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell on several cards, as launch() starts it
    for hidden, kind in (("--rank", int), ("--port", int), ("--t0", float)):
        p.add_argument(hidden, type=kind, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    try:
        chips = 1
        if args.rank is None:
            cell = find(load_json(MANIFEST)["workloads"], args.workload,
                        "workload")
            chips = cell["chips"]
        if chips > 1:
            cards(cell)
            out = launch(args, chips)
        else:
            out = run(args)
    except Fail as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    if out is None:  # a rank other than 0 prints nothing
        return 0
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
