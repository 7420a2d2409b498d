"""Tracing and timing helpers (port of ``utils/profiling.py``).

* :func:`trace` — ``torch.profiler`` around a block, writing a Chrome
  trace (open it in ``chrome://tracing`` or Perfetto) and the recorder's
  ``spans.json`` beside it;
* :func:`timeit` / :func:`time_stages` — median seconds per call, fenced
  by :func:`fence`; CUDA events on the card, ``perf_counter`` on the CPU;
* :func:`scan_marginal_cost` — the marginal seconds per iteration of a
  function inside one timed loop, less a trivial harness;
* :func:`capture_seconds` — the warm-up and capture seconds of every
  CUDA graph made inside a block (:func:`.graphs.capture_seconds`, which
  each :class:`~.graphs.StepGraph` reports to), what the graphs cost
  before their first replay;
* :mod:`spans` — the recorder (:mod:`.spans`): the stage clock inside the
  captured steps and the host spans of the rollout loop and the object
  API.

Reading ``spans.json`` (after a missed deadline, say: the last cycles of a
control loop, split by stage).  Every time is ``perf_counter_ns`` of the
process; the device's stamps are moved onto that clock by the
calibration, within ``calibration_error_ns``.

* ``spans``: ``names`` and ``records``, one list a span in the order they
  opened: ``[slot, name id, parent slot (-1: none), request id, start,
  end, profiled]``.  A rollout is a ``rollout`` span (request id: the
  call) with ``inputs``, ``lookup``, ``capture`` or ``copy_in``,
  ``replay`` and ``result``; an object-API cycle is ``get_control``
  (request id: the cycle) with ``prepare``, ``replay`` (or ``capture``),
  ``readback`` (blocked on the device) and ``unpack``, then ``drive``
  under the same id with ``upload``, ``replay`` and ``clone``.  A span's
  self time is its duration less its children's.
* ``stages``: for each label (``rollout``: the last call's steps;
  ``control`` and ``drive``: the object API's last cycles), ``names`` and
  ``rows``, one a step: ``[request id, profiled, start of each stage...,
  end]``.  Stage ``i`` lasted ``row[2 + i + 1] - row[2 + i]``; a control
  row and a drive row of one cycle share its request id, and the
  ``get_control`` span of that id encloses the control row.
* ``counters``: ``graph_captures``, the CUDA graphs captured so far, and
  what the recorder's counters (:func:`.spans.counters`) gained inside the
  traced block: ``cell_table_fallbacks``, the lane-steps whose scan fell
  back from its waypoint's row of a pruned cell table to the global one.

PyTorch returns from a CUDA call before the device has finished, so every
time here is taken after a synchronise of the devices the result lives on.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from multi_purpose_mpc_tpu_torch.utils import graphs, spans
from multi_purpose_mpc_tpu_torch.utils.graphs import capture_seconds  # noqa: F401
from multi_purpose_mpc_tpu_torch.utils.tree import leaves


def _cuda_devices(out):
    return {x.device for x in leaves(out)
            if isinstance(x, torch.Tensor) and x.is_cuda}


def fence(out):
    """Wait until every CUDA tensor in ``out`` is computed (a synchronise
    of each device they live on); returns ``out``.  On the CPU there is
    nothing to wait for."""
    for d in _cuda_devices(out):
        torch.cuda.synchronize(d)
    return out


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile a block with ``torch.profiler`` (CPU, and CUDA where there
    is a card) and write its Chrome trace to ``logdir/trace.json`` and the
    recorder's spans, stage rows and counters to ``logdir/spans.json``:
    ``with trace(d): run_step()``.  ``logdir`` defaults to a directory
    under the temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "mpc_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    before = spans.counters()
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        gained = {k: n - before.get(k, 0)
                  for k, n in spans.counters().items()}
        spans.dump(os.path.join(logdir, "spans.json"),
                   {"graph_captures": graphs.captures, **gained})


def _time_once(run: Callable, device: Optional[torch.device]) -> float:
    """Seconds of one call of ``run()``, fenced: CUDA events on the current
    stream of ``device`` when it is a CUDA device, else the host clock."""
    if device is not None and device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record(stream)
        out = run()
        ev1.record(stream)
        fence(out)
        ev1.synchronize()
        return ev0.elapsed_time(ev1) / 1e3
    t0 = time.perf_counter()
    fence(run())
    return time.perf_counter() - t0


def _device_of(out) -> Optional[torch.device]:
    devs = _cuda_devices(out)
    return min(devs, key=str) if devs else None


def timeit(fn: Callable, *args, warmup: int = 2, iters: int = 10,
           **kwargs) -> float:
    """Median seconds per call of ``fn(*args, **kwargs)``, each call fenced
    (:func:`fence`).  Timed with CUDA events when the warm-up's result
    lives on the card, with the host clock otherwise."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fence(fn(*args, **kwargs))
    device = _device_of(out)
    times = sorted(_time_once(lambda: fn(*args, **kwargs), device)
                   for _ in range(iters))
    return times[len(times) // 2]


def time_stages(stages: Dict[str, Callable], warmup: int = 2,
                iters: int = 10) -> Dict[str, float]:
    """Time a dict of thunks; returns {name: median_seconds}."""
    return {name: timeit(fn, warmup=warmup, iters=iters)
            for name, fn in stages.items()}


def _float_sum(out, device) -> torch.Tensor:
    """A float32 scalar that depends on every float leaf of ``out``."""
    s = torch.zeros((), dtype=torch.float32, device=device)
    for x in leaves(out):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            s = s + x.sum().float().to(device)
    return s


def _float_first(out, device) -> torch.Tensor:
    """A float32 scalar from one element of every float leaf of ``out``:
    the trivial harness's cheap use of the perturbed arguments."""
    s = torch.zeros((), dtype=torch.float32, device=device)
    for x in leaves(out):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            s = s + x.reshape(-1)[0].float().to(device)
    return s


def scan_marginal_cost(fn: Callable, args: tuple, perturb: Callable,
                       steps: int = 32, repeats: int = 3) -> float:
    """Marginal seconds per iteration of ``fn(*args)``: ``steps`` calls on
    iteration-dependent arguments ``perturb(args, i)``, each reduced into a
    running scalar, timed in one window (CUDA events on the card, the host
    clock on the CPU), less the same loop with a trivial body that only
    touches the perturbed arguments, over ``steps``.

    On the card the window holds what the stream took, the host's launch
    overhead included wherever it exceeds the device's work.  Returns the
    best of ``repeats`` windows for each loop, and never less than 0.
    """
    device = _device_of(args) or torch.device("cpu")

    def loop(body):
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(steps):
            acc = acc + body(perturb(args, i))
        return acc

    def best(body) -> float:
        fence(loop(body))  # warm-up
        return min(_time_once(lambda: loop(body), device)
                   for _ in range(repeats))

    t_floor = best(lambda a: _float_first(a, device))
    t_fn = best(lambda a: _float_sum(fn(*a), device))
    return max((t_fn - t_floor) / steps, 0.0)
