"""Device ms a fleet step of stage ``locate``: the step's localization
and horizon tables (torch glue), by the stage clock inside the replayed
step, the mean over the last call's steps. Moves car_steps_per_s."""

from benchmark.metrics._stages import step_ms


def read(ctx):
    return step_ms("locate")
