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
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_purpose_mpc_tpu")
KERNELS = ("corridor_select", "admm_fused", "admm_structured", "extract_occ",
           "writeback_extract", "writeback_extract_packed", "scan_cells")


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


def run(args) -> dict:
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = find(manifest["workloads"], args.workload, "workload")
    conf = find(manifest["configs"], cell["config"], "configuration")
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))

    import torch

    if not torch.cuda.is_available():
        raise Fail("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        raise Fail(f"{cell['name']} needs {cell['chips']} CUDA devices, "
                   f"{torch.cuda.device_count()} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # one process, few threads: a steadier host
    sys.path.insert(0, ROOT)
    return measure(args, manifest, cell, cfg, traffic)


def measure(args, manifest, cell, cfg, traffic):
    """Set-up, the window, the traced calls and the check of one run."""
    import torch

    from benchmark import checks, drivers, scenario
    from benchmark import trace as tracing
    from multi_purpose_mpc_tpu_torch.utils import graphs, kernels

    marks = [("imports", time.perf_counter())]
    kernels.build_all(KERNELS)
    for name in KERNELS:
        kernels.load(name)
    marks.append(("kernels", time.perf_counter()))
    sc = scenario.configs(cfg, ROOT)
    driver = drivers.make(sc, traffic, args.seed, "cuda")
    marks.append(("scenario and inputs", time.perf_counter()))
    with graphs.capture_seconds() as caps:
        driver.warm_up()
    torch.cuda.synchronize()
    marks.append(("first calls", time.perf_counter()))
    setup_s = time.perf_counter() - T_START
    info(setup=" ".join(f"{k} {b - a:.3f} s" for (_, a), (k, b) in zip(
        [("start", T_START)] + marks[:-1], marks)))

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
                      k7_in_range=k7() if k7 is not None else None)
        for m in for_cell(manifest["per_layer"], cell["name"]):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    torch.cuda.synchronize()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if args.trace:
        device.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        out = run(args)
    except Fail as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
