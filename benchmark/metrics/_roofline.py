"""Shared arithmetic of the ``*_roofline_pct`` readers."""


def share(ctx, kernel: str, ops: int, nbytes: int, launches: int = None):
    """100 x the least time of ``launches`` launches of ``kernel`` (the
    larger of ``ops`` over the float32 peak and ``nbytes`` over the HBM
    peak, both per launch) over their device time; None without launches."""
    n = ctx.trace.launches(ctx.is_kernel(kernel))
    if n == 0:
        return None
    seconds = ctx.trace.seconds(ctx.is_kernel(kernel))
    bound = max(ops / ctx.peaks["fp32_flop_per_s"],
                nbytes / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * bound * (launches or n) / seconds
