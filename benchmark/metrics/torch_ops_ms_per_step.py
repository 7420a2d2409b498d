"""Device time a step of every kernel that is neither a hand kernel of the
port (``benchmark/kernels/``) nor NCCL's: locate, the free runs, the plant
and the log, the glue between the kernels.  Moves car_steps_per_s."""


def read(ctx):
    glue = lambda name: not (ctx.is_hand_kernel(name) or "nccl" in name.lower()
                             or name.startswith(("Memcpy", "Memset")))
    return 1e3 * ctx.trace.seconds(glue) / ctx.steps
