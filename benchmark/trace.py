"""The device trace of a traced window: torch.profiler's CUDA activity
reduced to each kernel's launches and device time, the device's busy time
(the union of every device operation's interval) against the window's
length, the operations that took most time and the longest idle gaps,
each named by the innermost host operation open at its midpoint."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class DeviceTrace:
    ops: dict  # device operation name -> [launches, seconds]
    busy_s: float
    window_s: float
    idle_gaps: list  # [[host operation, seconds], ...], longest first

    def seconds(self, match: Callable[[str], bool]) -> float:
        return sum(s for name, (_, s) in self.ops.items() if match(name))

    def launches(self, match: Callable[[str], bool]) -> int:
        return sum(n for name, (n, _) in self.ops.items() if match(name))

    def top(self, n: int = 10) -> list:
        ranked = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name, s] for name, (_, s) in ranked]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, window_s: float, n_gaps: int = 10) -> DeviceTrace:
    """``events``: the profiler's ``events()``; microseconds in, seconds
    out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        (device if e.device_type == DeviceType.CUDA else host).append(e)
    ops: dict = {}
    spans = []
    for e in device:
        a, b = e.time_range.start, e.time_range.end
        if b <= a:
            continue
        rec = ops.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) * 1e-6
        spans.append((a, b))
    merged = _merge(spans)
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:n_gaps]
    named = []
    for length, at in gaps:
        mid = at + length / 2
        covering = [e for e in host
                    if e.time_range.start <= mid < e.time_range.end]
        inner = min(covering, key=lambda e: e.time_range.end
                    - e.time_range.start, default=None)
        named.append([inner.name if inner is not None else "host (untraced)",
                      length * 1e-6])
    return DeviceTrace(ops=ops, busy_s=busy, window_s=window_s,
                       idle_gaps=named)


def traced(fn: Callable[[], None]) -> DeviceTrace:
    """Run ``fn()`` under torch.profiler's CPU and CUDA activity and reduce
    its trace; the window is timed on the host between synchronises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return reduce(prof.events(), window)
