"""K1's device time a fleet step (QP solve layer): moves car_steps_per_s."""


def read(ctx):
    if not ctx.trace.launches(ctx.is_kernel("K1")):
        return None
    return 1e3 * ctx.trace.seconds(ctx.is_kernel("K1")) / ctx.steps
