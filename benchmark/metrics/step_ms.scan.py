"""Device ms a fleet step of stage ``scan``: the LiDAR scan, K7 with its
torch prologue and epilogue and the hit pixels (LiDAR scan layer), by
the stage clock inside the replayed step, the mean over the last call's
steps. Moves car_steps_per_s."""

from benchmark.metrics._stages import step_ms


def read(ctx):
    return step_ms("scan")
