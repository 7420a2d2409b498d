"""Device ms a fleet step of stage ``extract``: the dynamic grid's corridor
re-extraction, K4 and K8 with their torch glue (torch glue layer), by the
stage clock inside the replayed step, the mean over the last call's
steps.  None where the step reads a static table or the fused LiDAR
step.  Moves car_steps_per_s."""

from benchmark.metrics._stages import step_ms


def read(ctx):
    return step_ms("extract")
