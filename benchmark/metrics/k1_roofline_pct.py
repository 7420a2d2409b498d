"""K1's frozen bound a launch (``counts/k1.py``) over its device time a
launch: moves car_steps_per_s."""

from benchmark.counts import k1
from benchmark.metrics._roofline import share


def read(ctx):
    s = ctx.shapes
    if s["stage_solver"] == "cr":
        return None
    return share(ctx, "K1", k1.ops(s["B"], s["N"], s["iterations"],
                                   s["rho_updates"], s["polish_iters"]),
                 k1.nbytes(s["B"], s["N"]))
