"""Rejected decisions whose certified violation floor is <= 0 (a feasible
QP left unconverged), over active decisions: moves accept_rate."""


def read(ctx):
    if ctx.window.active == 0:
        return None
    return 100.0 * ctx.window.solver_fail / ctx.window.active
