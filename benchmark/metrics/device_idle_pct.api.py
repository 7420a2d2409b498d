"""The traced window's wall time with no operation on the device, over
object-API control cycles: moves control_ms_p95."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
