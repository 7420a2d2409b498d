"""The traced window's wall time with no operation on the device, over
fleet rollouts: moves car_steps_per_s."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
