"""Device ms a control cycle of stage ``solve``: K3 (QP solve layer), by
the stage clock inside the object API's graphs, the median over the
measured window's cycles (no profiler). Moves control_ms_p95."""

from benchmark.metrics._stages import cycle_ms


def read(ctx):
    return cycle_ms(ctx, "solve")
