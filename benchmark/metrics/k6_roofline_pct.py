"""K6's frozen bound a launch (``counts/k6.py``, bound by bytes) over its
device time a launch: moves car_steps_per_s."""

from benchmark.counts import k6
from benchmark.metrics._roofline import share


def read(ctx):
    s = ctx.shapes
    if "WR" not in s:
        return None
    return share(ctx, "K6", k6.ops(s["B"], s["WR"], s["W"], s["nb"]),
                 k6.nbytes(s["B"], s["WR"], s["W"], s["nb"], s["N"], s["K"]))
