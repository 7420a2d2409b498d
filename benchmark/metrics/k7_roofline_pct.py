"""K7's frozen bound (``counts/k7.py``: the pair tests of the in-range
cells of every traced scan) over its device time: moves car_steps_per_s."""

from benchmark.counts import k7
from benchmark.metrics._roofline import share


def read(ctx):
    if ctx.k7_in_range is None:
        return None
    n, lanes = ctx.k7_in_range
    nb = ctx.shapes["nb"]
    return share(ctx, "K7", k7.ops(n, nb), k7.nbytes(n, lanes, nb), launches=1)
