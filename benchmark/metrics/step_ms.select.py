"""Device ms a fleet step of stage ``select``: the horizon block,
corridor selection (K2) and the solver's inputs (torch glue), by the
stage clock inside the replayed step, the mean over the last call's
steps. Moves car_steps_per_s."""

from benchmark.metrics._stages import step_ms


def read(ctx):
    return step_ms("select")
