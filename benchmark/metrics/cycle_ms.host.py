"""Host ms a control cycle in ``get_control`` + ``drive`` less the time
blocked on the device's copy (``readback``), by the program's host
spans, the median over the measured window's cycles (object API layer).
Moves control_ms_p95."""

from benchmark.metrics._stages import host_ms


def read(ctx):
    return host_ms(ctx)
