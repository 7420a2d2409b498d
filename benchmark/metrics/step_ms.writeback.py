"""Device ms a fleet step of stage ``writeback``: the map write-back and
extraction, K6 (map write-back and extraction layer), by the stage clock
inside the replayed step, the mean over the last call's steps. Moves
car_steps_per_s."""

from benchmark.metrics._stages import step_ms


def read(ctx):
    return step_ms("writeback")
