"""The port's recorder: a stage clock that captured steps carry, and host
spans at the rollout loop's and the object API's boundaries.

A CUDA graph replay keeps no host range: the profiler ties every kernel of
a replay to one ``cudaGraphLaunch``.  So a step's stages are recorded on
the device, inside the graph:

* :class:`StageRing` — a small (rows, :data:`COLS`) int64 ring and its
  device row counter, owned by the graph's entry and allocated before the
  capture.  While a step runs under :class:`recording` (the entry's
  ``step``), :func:`stage` marks a stage boundary: on a CUDA ring it
  launches the one-thread kernel ``csrc/stage_clock.cu``, which writes
  ``%globaltimer`` (ns) into ``ring[count % rows, col]`` — eagerly in
  eager code; during a capture as a graph node on a branch of its own,
  which the step's end joins, so only the last mark delays the step; on
  a CPU ring it writes
  ``time.perf_counter_ns()`` into the same layout.  Each mark ends the
  stage before it and starts the next; :meth:`StageRing.end`, the step's
  last mark, also advances the row counter, so every replay writes the
  next row with no host involvement.  The marks count nothing in
  ``kernels.launch_counters()``.
* :class:`span` — ``perf_counter_ns`` at entry and exit into a
  preallocated host ring (:data:`HOST_RECORDS` records of name, own
  slot, parent slot, request id, start, end, profiled); :func:`phase`
  splits the innermost span into children one after the other, one stamp
  a boundary.  While a torch.profiler session is active each span and
  child is also a profiler range (a host op, not a user annotation, which
  the profiler would mirror onto the device), so the trace's idle gaps
  are named by the program's spans.
  Request ids: :func:`next_request` advances a kind's id (a rollout call,
  an API cycle), :func:`request` reads it; a span without one takes its
  parent's.

Device and host clocks: under torch.profiler the mark kernels sit in the
device trace beside the host spans.  Without it, :func:`calibration`
relates ``%globaltimer`` to ``perf_counter_ns`` once per device (a mark
launched between two host stamps after a synchronise; the error is half
the tightest of several brackets).

Counters: :func:`tally` is a named int64 on a device that a step adds to
on the device, for counts that depend on the data (a captured step adds
at every replay); :func:`counters` reads them.

Readers: :func:`ring` (the ring of a label that recorded a step last) and
its :meth:`StageRing.table`, :func:`host_records`, :func:`counters`;
:func:`dump` writes them as JSON (``utils.profiling.trace`` writes
``spans.json``).
"""

from __future__ import annotations

import ctypes
import functools
import json
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from multi_purpose_mpc_tpu_torch.utils import kernels

# marks a row: up to COLS - 1 stages, then the step's end in the last column
COLS = 16
END = COLS - 1
# rows of an object-API graph's ring: a 30 s window of ~4 ms cycles, the
# traced cycles after it and the warm-up
API_ROWS = 16384
# host span records kept: nine an object-API cycle (two spans, seven
# children), for more cycles than API_ROWS
HOST_RECORDS = 1 << 18

# a profiler range that is a host op: ``record_function``'s ranges are
# user annotations, which the CUDA profiler mirrors onto the device's
# timeline as events spanning the kernels they launched
_RecordFunction = torch._C._profiler._RecordFunctionFast
_now = time.perf_counter_ns


class _Local(threading.local):
    def __init__(self):
        self.ring = None  # the StageRing a step records into
        self.stack = []  # the open spans


_local = _Local()
_latest: dict = {}  # label -> the StageRing that recorded a step last
_requests: dict = {}  # kind -> its last request id
_calibrations: dict = {}  # device -> Calibration
_sides: dict = {}  # device -> the stream captured marks run on
_tallies: dict = {}  # (name, device) -> 0-d int64 device count


# ---------------------------------------------------------------- device


@functools.lru_cache(maxsize=None)
def _mark_fn():
    fn = kernels.load("stage_clock").stage_clock_mark
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_mark(ts, count, col: int, advance: bool) -> None:
    rc = _mark_fn()(ts.data_ptr(), count.data_ptr(), ts.shape[0],
                    ts.shape[1], col, int(advance),
                    torch.cuda.current_stream(ts.device).cuda_stream)
    kernels.check_launch(rc, "stage_clock_mark_kernel")


def _side_stream(device):
    """The stream a captured step's marks branch onto, one a device."""
    side = _sides.get(device)
    if side is None:
        side = _sides[device] = torch.cuda.Stream(device)
    return side


class Calibration(NamedTuple):
    offset_ns: int  # perf_counter_ns - %globaltimer
    error_ns: int  # half the bracket around the mark


def calibration(device) -> Calibration:
    """``perf_counter_ns - %globaltimer`` on ``device``, measured at its
    first use: 16 marks, each launched between two host stamps after a
    synchronise; the tightest bracket's middle and half width.  Zero on
    the CPU, whose rings hold ``perf_counter_ns``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return Calibration(0, 0)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _calibrations:
        ts = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        best = None
        for _ in range(16):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter_ns()
            _launch_mark(ts, count, 0, False)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter_ns()
            half = (t1 - t0) // 2
            if best is None or half < best.error_ns:
                best = Calibration((t0 + t1) // 2 - int(ts[0, 0]), half)
        _calibrations[dev] = best
    return _calibrations[dev]


class StageTable(NamedTuple):
    """The recorded steps of a ring, oldest first."""

    names: list  # stage names, in column order
    # (steps, len(names) + 1) int64 ns: each stage's start, then the end
    ts: np.ndarray
    rid: np.ndarray  # (steps,) the request id open when the step ran
    profiled: np.ndarray  # (steps,) bool: a profiler session was active

    def durations_ns(self) -> np.ndarray:
        """(steps, len(names)): each stage's duration."""
        return np.diff(self.ts, axis=1)


class StageRing:
    """A ring of ``rows`` step rows of :data:`COLS` marks on ``device``,
    and its row counter.  ``label`` names the steps it records (the
    readers' key).  Host-side it keeps each recorded step's request id and
    profiler flag (:meth:`note`, run where the step runs: an eager step's
    end, a graph's replay through ``graphs.Entry.replay``).  The host's
    count of steps, ``issued``, equals the device's ``count`` as long as
    every replay of a marked graph goes through ``Entry.replay``;
    :meth:`table` checks it."""

    def __init__(self, label: str, rows: int, device):
        self.label, self.rows = label, rows
        self.device = torch.device(device)
        self.ts = torch.zeros((rows, COLS), dtype=torch.int64,
                              device=self.device)
        self.count = torch.zeros((), dtype=torch.int64, device=self.device)
        self.names: list = []
        self.rid = np.full(rows, -1, np.int64)
        self.profiled = np.zeros(rows, bool)
        self.issued = 0  # steps recorded, as the host counts them
        if self.device.type == "cuda":
            calibration(self.device)
        else:
            self._host = self.ts.numpy()

    def mark(self, name: str) -> None:
        """Start stage ``name`` (ending the one before)."""
        try:
            col = self.names.index(name)
        except ValueError:
            if len(self.names) == END:
                raise ValueError(f"a step records at most {END} stages") \
                    from None
            col = len(self.names)
            self.names.append(name)
        self._stamp(col, False)

    def end(self) -> None:
        """The step's last mark: ends its last stage and advances the row
        counter."""
        self._stamp(END, True)
        if not (self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            self.note()

    def _stamp(self, col: int, advance: bool) -> None:
        if self.device.type == "cuda":
            if not torch.cuda.is_current_stream_capturing():
                _launch_mark(self.ts, self.count, col, advance)
                return
            # in a graph the marks form a branch of their own: each waits
            # for the step's kernels before it, and nothing but the step's
            # end waits for a mark, so of a step's marks only its last
            # lies on the step's path (a capture must join the branch)
            main = torch.cuda.current_stream(self.device)
            side = _side_stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                _launch_mark(self.ts, self.count, col, advance)
            if advance:
                main.wait_stream(side)
            return
        self._host[self.issued % self.rows, col] = time.perf_counter_ns()
        if advance:
            self.count += 1

    def note(self) -> None:
        """Host bookkeeping of one step run: its request id and the
        profiler's state."""
        slot = self.issued % self.rows
        self.rid[slot] = current_request()
        self.profiled[slot] = _autograd_profiler._is_profiler_enabled
        self.issued += 1
        _latest[self.label] = self

    def table(self) -> StageTable:
        """The recorded steps (at most ``rows``), oldest first; reads the
        ring back from the device."""
        count = int(self.count)
        if count != self.issued:
            raise RuntimeError(
                f"stage ring {self.label!r}: the device counted {count} "
                f"steps, the host {self.issued} (a marked graph replayed "
                "outside graphs.Entry.replay)")
        n = min(self.issued, self.rows)
        order = np.arange(self.issued - n, self.issued) % self.rows
        cols = list(range(len(self.names))) + [END]
        ts = self.ts.cpu().numpy()[order][:, cols]
        return StageTable(list(self.names), ts, self.rid[order].copy(),
                          self.profiled[order].copy())


class recording:
    """``with recording(ring):`` — :func:`stage` marks go to ``ring``."""

    __slots__ = ("ring", "prev")

    def __init__(self, ring):
        self.ring = ring

    def __enter__(self):
        self.prev = _local.ring
        _local.ring = self.ring
        return self.ring

    def __exit__(self, *exc):
        _local.ring = self.prev
        return False


def stage(name: str) -> None:
    """Mark the start of stage ``name`` of the step being recorded (none
    outside a :class:`recording` block)."""
    ring = _local.ring
    if ring is not None:
        ring.mark(name)


def ring(label: str):
    """The :class:`StageRing` of ``label`` that recorded a step last, or
    None."""
    return _latest.get(label)


# ------------------------------------------------------------------ host


class _HostRing:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.records = [None] * capacity
        self.n = 0  # spans opened so far: the next slot


_host = _HostRing(HOST_RECORDS)


def next_request(kind: str) -> int:
    """Advance and return the request id of ``kind`` (from 0)."""
    rid = _requests[kind] = _requests.get(kind, -1) + 1
    return rid


def request(kind: str) -> int:
    """The current request id of ``kind`` (-1 before the first)."""
    return _requests.get(kind, -1)


def current_request() -> int:
    """The request id of the innermost open span (-1 outside any)."""
    stack = _local.stack
    return stack[-1].rid if stack else -1


class span:
    """``with span(name, rid):`` — one host span; ``rid`` defaults to the
    enclosing span's.  Its children run one after the other:
    :func:`phase` ends the current child and starts the next, and the
    span's exit ends the last."""

    # kid: the open child's (slot, name, start), krf its profiler range
    __slots__ = ("name", "rid", "slot", "parent", "t0", "rf", "kid", "krf")

    def __init__(self, name: str, rid: int = None):
        self.name, self.rid = name, rid

    def __enter__(self):
        stack = _local.stack
        if stack:
            top = stack[-1]
            self.parent = top.slot
            if self.rid is None:
                self.rid = top.rid
        else:
            self.parent = -1
            if self.rid is None:
                self.rid = -1
        h = _host
        self.slot = h.n
        h.n += 1
        stack.append(self)
        self.kid = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _RecordFunction(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.t0 = _now()
        return self

    def _end_kid(self, t: int, et=None, ev=None, tb=None) -> None:
        slot, name, t0 = self.kid
        krf = self.krf
        if krf is not None:
            krf.__exit__(et, ev, tb)
        h = _host
        h.records[slot % h.capacity] = (slot, name, self.slot, self.rid, t0,
                                        t, krf is not None)

    def __exit__(self, et, ev, tb):
        t1 = _now()
        if self.kid is not None:
            self._end_kid(t1, et, ev, tb)
        rf = self.rf
        if rf is not None:
            rf.__exit__(et, ev, tb)
        _local.stack.pop()
        h = _host
        h.records[self.slot % h.capacity] = (
            self.slot, self.name, self.parent, self.rid, self.t0, t1,
            rf is not None)
        return False


def phase(name: str) -> None:
    """End the innermost open span's current child, if any, and start its
    child ``name`` (nothing outside a span)."""
    stack = _local.stack
    if not stack:
        return
    top = stack[-1]
    t = _now()
    if top.kid is not None:
        top._end_kid(t)
    h = _host
    top.kid = (h.n, name, t)
    h.n += 1
    if _autograd_profiler._is_profiler_enabled:
        top.krf = _RecordFunction(name)
        top.krf.__enter__()
    else:
        top.krf = None


def call_span(name: str, kind: str):
    """Decorate a function: each call is a host span ``name`` under a new
    request id of ``kind``, whose first child is ``inputs``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, next_request(kind)):
                phase("inputs")
                return fn(*args, **kwargs)
        return call
    return wrap


class HostTable(NamedTuple):
    """Completed host spans, in the order they opened."""

    names: list  # name of each id
    slot: np.ndarray
    name: np.ndarray  # name id
    parent: np.ndarray  # parent's slot, -1 for none
    rid: np.ndarray
    t0: np.ndarray  # perf_counter_ns
    t1: np.ndarray
    profiled: np.ndarray


def host_records() -> HostTable:
    recs = sorted(r for r in _host.records if r is not None)
    names = sorted({r[1] for r in recs})
    ids = {n: i for i, n in enumerate(names)}
    cols = list(zip(*recs)) if recs else [()] * 7
    arr = lambda c, dt: np.asarray(c, dtype=dt)
    return HostTable(names, arr(cols[0], np.int64),
                     arr([ids[n] for n in cols[1]], np.int64),
                     arr(cols[2], np.int64), arr(cols[3], np.int64),
                     arr(cols[4], np.int64), arr(cols[5], np.int64),
                     arr(cols[6], bool))


def reset() -> None:
    """Forget every span, request id and ring (the rings themselves stay
    with their entries)."""
    global _host
    _host = _HostRing(HOST_RECORDS)
    _requests.clear()
    _latest.clear()


# -------------------------------------------------------------- counters


def tally(name: str, device) -> torch.Tensor:
    """The 0-d int64 counter ``name`` on ``device``, made at its first use
    and kept for the process (a captured step that adds to it adds at every
    replay)."""
    key = (name, torch.device(device))
    t = _tallies.get(key)
    if t is None:
        t = _tallies[key] = torch.zeros((), dtype=torch.int64, device=device)
    return t


def counters() -> dict:
    """The device tallies, ``{name: count}`` summed over devices (a read
    back from each): totals since the process started."""
    out: dict = {}
    for (name, _), t in sorted(_tallies.items(), key=lambda kv: kv[0][0]):
        out[name] = out.get(name, 0) + int(t)
    return out


# ---------------------------------------------------------------- export


def dump(path: str, counters: dict = None) -> None:
    """Write the recorder's host spans, the stage rows of each label's
    latest ring (stamps on the ``perf_counter_ns`` clock through
    :func:`calibration`) and ``counters`` as JSON to ``path``."""
    host = host_records()
    stages = {}
    for label, r in sorted(_latest.items()):
        t = r.table()
        cal = calibration(r.device)
        stages[label] = {
            "device": str(r.device), "names": t.names,
            "calibration_error_ns": cal.error_ns,
            "rows": [[int(rid), bool(p), *(int(v) + cal.offset_ns
                                           for v in row)]
                     for rid, p, row in zip(t.rid, t.profiled, t.ts)]}
    out = {"clock": "perf_counter_ns",
           "spans": {"names": host.names,
                     "fields": ["slot", "name", "parent", "rid", "start",
                                "end", "profiled"],
                     "records": [list(map(int, r)) for r in zip(
                         host.slot, host.name, host.parent, host.rid,
                         host.t0, host.t1, host.profiled)]},
           "stages": stages, "counters": dict(counters or {})}
    with open(path, "w") as f:
        json.dump(out, f)
