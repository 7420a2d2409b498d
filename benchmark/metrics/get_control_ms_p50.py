"""The median of ``MPC.get_control`` on the host clock, over the window's
cycles (object API layer): moves control_ms_p95."""

import statistics


def read(ctx):
    if not ctx.window.get_control_s:
        return None
    return 1e3 * statistics.median(ctx.window.get_control_s)
