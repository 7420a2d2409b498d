"""CUDA-graph capture of a step: the port's counterpart of the JAX
package's ``jax.jit`` (of a rollout's ``lax.scan`` body, of the object
API's control step).

A step that reads and writes only static tensors — buffers made before
the capture, static copies of its inputs (:class:`Entry`) and constants
that outlive the graph — runs its first application eagerly on a side stream (the
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

:class:`Entry` owns static copies of a step's tensor inputs and the
graphs captured on them: a call copies its inputs in and replays.  A
rollout's :class:`RolloutEntry` adds the carry's second buffer set, the
(T, B) logs and the step counter, and lives in :data:`rollout_cache`
(:class:`GraphCache`), the counterpart of ``jax.jit``'s compile cache:
one entry per step, static configuration, step count and layout,
captured at the first call and replayed by every later call with fresh
inputs of the same shapes.  :func:`clear_cache` empties it, as
``jax.clear_caches`` does.

An entry may own a :class:`~.spans.StageRing` (a rollout's always does):
its steps mark their stages into it on the device, inside the graphs, and
each replay (:meth:`Entry.replay`) notes its row on the host.  :data:`captures` counts the
:class:`StepGraph` objects built, beside :func:`capture_seconds`.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from multi_purpose_mpc_tpu_torch.utils import kernels, spans
from multi_purpose_mpc_tpu_torch.utils.tree import leaves, rebuild

# .disabled: depth of disable_capture() blocks; .records: the lists that
# capture_seconds() blocks fill
_local = threading.local()
# StepGraphs built in this process (each a capture)
captures = 0
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
        global captures
        captures += 1
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


class Entry:
    """Static copies of ``args`` (a tree of tensors) and the graphs
    captured on them (:meth:`capture`; they share the first one's memory
    pool, being replayed one after the other on one stream).  A call
    copies its own arguments in (:meth:`copy_in`) and replays: what a
    graph reads must come from :attr:`args` or outlive the entry, since a
    tensor read from anywhere else is baked in at the capture.
    ``ring``: the :class:`~.spans.StageRing` its graphs' steps record
    into, if any, allocated before the capture; :meth:`replay` notes each
    replay's row in it."""

    def __init__(self, args, ring=None):
        self._flat = [x.clone(memory_format=torch.contiguous_format)
                      for x in leaves(args)]
        self.args = rebuild(args, self._flat)
        self.graphs = []
        self.ring = ring

    def copy_in(self, args) -> None:
        new = leaves(args)
        if len(new) != len(self._flat):
            raise ValueError(f"{len(new)} leaves for an entry of "
                             f"{len(self._flat)}")
        for buf, x in zip(self._flat, new):
            buf.copy_(x)

    def capture(self, fn: Callable, warmup: Optional[Callable] = None):
        """A :class:`StepGraph` of ``fn`` (after ``warmup``), kept here."""
        pool = self.graphs[0].pool() if self.graphs else None
        g = StepGraph(fn, warmup=warmup, pool=pool)
        self.graphs.append(g)
        return g

    def replay(self, graph: StepGraph) -> None:
        """Replay one of :attr:`graphs` and note its step in the ring."""
        graph.replay()
        if self.ring is not None:
            self.ring.note()


class RolloutEntry(Entry):
    """A rollout of ``steps`` steps: ``args = (carry0, inputs)`` copied
    in (the carry's buffer set 0 and the step's inputs), buffer set 1, the
    (T, B) logs (made at the first step), the device step counter ``t``
    and the stage ring (``steps`` rows: its counter runs on across calls,
    and each call records ``steps`` steps, so row ``i`` is the last
    call's step ``i``).
    :meth:`step` applies ``sim_step(carry, dst, inputs) -> (carry, log)``
    once: it reads set ``parity``, writes its log row at ``t`` and its
    new carry into the other set; the step's stages are recorded, the
    last (``post``) through the log row and the carry copy.  ``group``:
    the process group the step all-reduces over, held so that its
    identity, part of the cache key, is not reused while the entry
    lives."""

    def __init__(self, carry0, inputs, steps: int, group=None):
        dev = leaves(carry0)[0].device
        super().__init__((carry0, inputs),
                         ring=spans.StageRing("rollout", steps, dev))
        self.steps = steps
        carry = leaves(self.args[0])
        self.bufs = (carry, [torch.empty_like(x) for x in carry])
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.logs = self.log_tree = self.pair = None
        self.group = group
        # the logs outlive the warm-up's side stream: they are made on
        # the caller's
        self._home = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                      else None)

    def step(self, sim_step: Callable, parity: int) -> None:
        src, dst = self.bufs[parity], self.bufs[1 - parity]
        like = self.args[0]
        with spans.recording(self.ring):
            new, log = sim_step(rebuild(like, src), rebuild(like, dst),
                                self.args[1])
        rows = leaves(log)
        if self.logs is None:
            with (torch.cuda.stream(self._home) if self._home is not None
                  else contextlib.nullcontext()):
                self.logs = [torch.empty((self.steps,) + tuple(f.shape),
                                         dtype=f.dtype, device=f.device)
                             for f in rows]
            self.log_tree = rebuild(log, self.logs)
        for buf, row in zip(self.logs, rows):
            buf.index_copy_(0, self.t, row.unsqueeze(0))
        self.t.add_(1)
        _copy_carry(leaves(new), dst)
        self.ring.end()

    def capture_pair(self, sim_step: Callable) -> None:
        """Run step 0 eagerly (the warm-up, a real step) and capture the
        step on each buffer set: ``pair[p]`` reads set ``p``."""
        g1 = self.capture(lambda: self.step(sim_step, 1),
                          warmup=lambda: self.step(sim_step, 0))
        self.pair = (self.capture(lambda: self.step(sim_step, 0)), g1)

    def result(self):
        """``(final carry, logs)`` after the rollout's steps: views of the
        entry's buffers, which its next call rewrites."""
        return (rebuild(self.args[0], self.bufs[self.steps % 2]),
                self.log_tree)


def _copy_carry(new, dst) -> None:
    """Copy a step's new carry leaves into the buffer set ``dst``."""
    if len(new) != len(dst):
        raise ValueError(f"a step returned {len(new)} carry leaves for "
                         f"{len(dst)}")
    for n, d in zip(new, dst):
        if n.shape != d.shape or n.dtype != d.dtype:
            raise ValueError(
                f"a step must keep its carry's shapes and dtypes: "
                f"{tuple(d.shape)} {d.dtype} became {tuple(n.shape)} "
                f"{n.dtype}")
        if n is not d:
            d.copy_(n)


# entries a device: the largest rollout of chip_smoke.py, the LiDAR fleet
# at B = 4096, peaks at 8.1-8.3 GiB above what its caller holds, most of
# it its graphs' pool, which stays resident while its entry is cached
# (PERF.md section 5, NVIDIA H100 80GB HBM3 at 700 W); four such entries
# hold some 33 GiB, under half of an 80 GB card, and a Monte-Carlo loop
# or a sweep over a few configurations reuses at most a few entries
CACHE_SIZE = 4


class GraphCache:
    """Least-recently-used :class:`Entry` objects by key, at most
    :data:`CACHE_SIZE` a device.  Evicting an entry drops its graphs and
    buffers: its memory pool goes back to the allocator's cache, as any
    freed tensor's does, until ``torch.cuda.empty_cache()``."""

    def __init__(self):
        self._devices: dict = {}

    def get(self, device, key):
        lru = self._devices.get(torch.device(device))
        entry = None if lru is None else lru.get(key)
        if entry is not None:
            lru.move_to_end(key)
        return entry

    def put(self, device, key, entry) -> None:
        lru = self._devices.setdefault(torch.device(device),
                                       collections.OrderedDict())
        lru[key] = entry
        lru.move_to_end(key)
        while len(lru) > CACHE_SIZE:
            lru.popitem(last=False)

    def clear(self) -> None:
        self._devices.clear()

    def __len__(self) -> int:
        return sum(len(lru) for lru in self._devices.values())


# the rollouts' cache (simulation._rollout)
rollout_cache = GraphCache()


def clear_cache() -> None:
    """Drop every cached rollout graph (the counterpart of
    ``jax.clear_caches``); the next call of each rollout captures anew.
    Call it before destroying a process group whose all-reduce a cached
    graph holds, to free that graph with its communicator."""
    rollout_cache.clear()
