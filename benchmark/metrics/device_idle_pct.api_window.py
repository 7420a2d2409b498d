"""The share of the measured window's control cycles' time (each cycle
from one ``get_control`` entry to the next, by the host spans) in which
neither object-API graph runs (their device intervals, by the stage
clock), with no profiler.  Moves control_ms_p95."""

from benchmark.metrics._stages import api_idle_pct


def read(ctx):
    return api_idle_pct(ctx)
