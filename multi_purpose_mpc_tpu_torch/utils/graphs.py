"""CUDA-graph capture of a step: the port's counterpart of the JAX
package's ``jax.jit`` (of a rollout's ``lax.scan`` body, of the object
API's control step).

A step that reads and writes only static tensors — buffers made before
the capture, and setup tensors (tables, paths, grids) that outlive the
graph — runs its first application eagerly on a side stream (the
warm-up: it builds and loads the kernels, runs their
``cudaFuncSetAttribute`` and fills the per-path caches) under
``torch.cuda.set_sync_debug_mode("error")``, so that a host sync in the
step raises.  The warm-up is a real step: its result is kept
(:attr:`StepGraph.first`), so a graphed loop pays no extra step for it.
The step is then captured into a ``torch.cuda.CUDAGraph`` on that
stream and replayed.  The capture calls ``capture_begin`` /
``capture_end`` itself: ``torch.cuda.graph`` would also synchronise the
device and empty the allocator's caches at every capture, a cost each
call of a graphed rollout would pay.  Each graph's memory pool is
released with the graph, and its blocks stay in the allocator's cache, as
any freed tensor's do, until ``torch.cuda.empty_cache()`` or an
allocation that cannot be met otherwise frees them.  A failed capture
raises; nothing reruns eagerly in its place.

The kernel wrappers' launch counters run in Python, so they see the
warm-up and the capture but not the replays: :class:`StepGraph` keeps the
warm-up's counts (its kernels ran), takes the capture's back (nothing
ran) and adds them at every replay, so a replayed step counts what an
eager step counts.

The capture rule (:func:`should_capture`): a step on a CUDA device is
captured, unless :func:`disable_capture` is active or the step
all-reduces over a gloo process group (gloo goes through the host, which
a graph cannot hold; NCCL collectives are captured).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from multi_purpose_mpc_tpu_torch.utils import kernels

# .disabled: depth of disable_capture() blocks; .records: the lists that
# capture_seconds() blocks fill
_local = threading.local()
# one warm-up and capture stream a device, as torch.cuda.graph keeps one:
# the allocator caches blocks per stream, so a new stream a call would
# allocate the warm-up's tensors anew every call
_streams: dict = {}


def capture_stream() -> torch.cuda.Stream:
    """The side stream every :class:`StepGraph` of the current device warms
    up and captures on."""
    dev = torch.cuda.current_device()
    if dev not in _streams:
        _streams[dev] = torch.cuda.Stream(dev)
    return _streams[dev]


@contextlib.contextmanager
def disable_capture():
    """Run every step in its eager form inside the block (this thread's
    steps), as ``jax.disable_jit`` does for the JAX package: the
    comparisons of ``chip_smoke.py`` and the CUDA tests hold each graph
    against it."""
    _local.disabled = getattr(_local, "disabled", 0) + 1
    try:
        yield
    finally:
        _local.disabled -= 1


def should_capture(device, group=None) -> bool:
    """The capture rule: True for a step on a CUDA ``device`` whose
    process ``group`` (if any) is not gloo, outside
    :func:`disable_capture`."""
    if getattr(_local, "disabled", 0) or torch.device(device).type != "cuda":
        return False
    return group is None or dist.get_backend(group) != dist.Backend.GLOO


def warm_up(fn: Callable, stream: torch.cuda.Stream):
    """``fn()`` on ``stream`` with every host sync an error; returns its
    result once the current stream has caught up with it."""
    stream.wait_stream(torch.cuda.current_stream())
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream):
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream().wait_stream(stream)
    return out


@contextlib.contextmanager
def capture_seconds():
    """Collect ``(warm-up s, capture s)`` of every :class:`StepGraph` made
    on this thread inside the block, each between two synchronises (only
    while a block is open)::

        with capture_seconds() as secs:
            simulate_fleet(...)
        capture_s = sum(c for _, c in secs)
    """
    records = _local.__dict__.setdefault("records", [])
    secs = []
    records.append(secs)
    try:
        yield secs
    finally:
        records.remove(secs)


def captured_launches(capture: Callable) -> dict:
    """Run ``capture()``; return the launches each wrapper counted during
    it (``{name: n}``, nonzero only) and take them back: a capture
    launches nothing."""
    start = kernels.launch_counts()
    capture()
    end = kernels.launch_counts()
    delta = {k: end[k] - start[k] for k in end if end[k] != start[k]}
    kernels.add_launches({k: -n for k, n in delta.items()})
    return delta


class StepGraph:
    """``fn()`` captured once into a CUDA graph; :meth:`replay` runs it
    again.  ``warmup()``, when given, runs first as :func:`warm_up` says,
    and is a real step: its result is :attr:`first` and its launches
    count.  Both run on :func:`capture_stream`.  ``out`` holds what the
    capture returned: static tensors that every replay rewrites.
    ``pool``: share another graph's memory pool (graphs replayed one after
    the other on one stream)."""

    def __init__(self, fn: Callable, warmup: Optional[Callable] = None,
                 pool=None):
        stream = capture_stream()
        self.graph = torch.cuda.CUDAGraph()
        records = getattr(_local, "records", None)
        clock = []

        def tick():
            if records:
                torch.cuda.synchronize()
                clock.append(time.perf_counter())

        def capture():
            with torch.cuda.stream(stream):
                self.graph.capture_begin(*(() if pool is None else (pool,)))
                try:
                    self.out = fn()
                finally:
                    self.graph.capture_end()

        tick()
        self.first = None if warmup is None else warm_up(warmup, stream)
        tick()
        self.launches = captured_launches(capture)
        tick()
        for r in records or ():
            r.append((clock[1] - clock[0], clock[2] - clock[1]))

    def pool(self):
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)
