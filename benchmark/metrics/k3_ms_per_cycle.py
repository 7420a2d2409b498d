"""K3's device time a control cycle of the object API: moves
control_ms_p95."""


def read(ctx):
    if not ctx.trace.launches(ctx.is_kernel("K3")):
        return None
    return 1e3 * ctx.trace.seconds(ctx.is_kernel("K3")) / ctx.steps
