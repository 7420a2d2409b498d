"""The first call's warm-up and capture seconds of its CUDA graphs, as
``utils.graphs.StepGraph`` times them (set-up layer): moves setup_s."""


def read(ctx):
    if not ctx.capture:
        return None
    return sum(w + c for w, c in ctx.capture)
