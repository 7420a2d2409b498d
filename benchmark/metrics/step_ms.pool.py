"""Device ms a fleet step of stage ``pool``: on a map shared over ranks,
the two mask all-reduces and the map's update, rank 0's exposed wait for
the slowest rank included (ranks layer), by the stage clock inside the
replayed step, the mean over the last call's steps.  None where the step
pools nothing or the program has no such stage.  Moves car_steps_per_s."""

from benchmark.metrics._stages import step_ms


def read(ctx):
    return step_ms("pool")
