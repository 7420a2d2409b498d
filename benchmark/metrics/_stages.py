"""Shared arithmetic of the readers of the port's recorder
(``multi_purpose_mpc_tpu_torch.utils.spans``): the stage clock's rows of
the last rollout call (``step_ms.*``), and the object API's stage rows and
host spans over the measured window's cycles (``cycle_ms.*``,
``device_idle_pct.api_window``).  Every function returns None where the
program has no recorder or the recorder holds no rows."""

import numpy as np


def recorder():
    """The port's recorder module, or None in a program without one."""
    try:
        from multi_purpose_mpc_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def step_ms(stage: str):
    """Mean ms of ``stage`` over the steps of the last rollout call."""
    spans = recorder()
    ring = spans.ring("rollout") if spans is not None else None
    if ring is None:
        return None
    t = ring.table()
    if stage not in t.names or len(t.ts) == 0:
        return None
    return float(t.durations_ns()[:, t.names.index(stage)].mean()) / 1e6


def api_cycles(ctx):
    """The measured window's object-API cycles: ``{"control": {stage: ns},
    "drive": ns, "busy": ns, "host": ns, "start": ns}``, arrays over the
    cycles in order.  A cycle is a request id with a control row and a
    drive row recorded without the profiler, and a ``get_control`` and a
    ``drive`` span; the window's are the last ``len(ctx.window.cycle_s)``
    of them (the warm-up's come before, the profiled ones after)."""
    spans = recorder()
    n = len(ctx.window.cycle_s)
    if spans is None or n == 0:
        return None
    rings = spans.ring("control"), spans.ring("drive")
    if None in rings:
        return None
    ctl, drv = (r.table() for r in rings)
    host = spans.host_records()
    name = {i: s for i, s in enumerate(host.names)}
    spans_of = {"get_control": {}, "drive": {}}
    readback = {}  # parent slot -> ns
    for slot, nid, parent, rid, t0, t1, prof in zip(*host[1:]):
        k = name[int(nid)]
        if prof:
            continue
        if k in spans_of:
            spans_of[k][int(rid)] = (int(slot), int(t0), int(t1))
        elif k == "readback":
            readback[int(parent)] = int(t1 - t0)
    rows = [{int(r): i for i, (r, p) in enumerate(zip(t.rid, t.profiled))
             if not p} for t in (ctl, drv)]
    rids = sorted(set(rows[0]) & set(rows[1]) & set(spans_of["get_control"])
                  & set(spans_of["drive"]))[-n:]
    if not rids:
        return None
    ci = np.array([rows[0][r] for r in rids])
    di = np.array([rows[1][r] for r in rids])
    cd = ctl.durations_ns()[ci]
    gc = [spans_of["get_control"][r] for r in rids]
    dr = [spans_of["drive"][r] for r in rids]
    host_ns = np.array([(g[2] - g[1]) + (d[2] - d[1]) - readback.get(g[0], 0)
                        for g, d in zip(gc, dr)])
    return {"rid": np.array(rids),
            "control": {s: cd[:, j] for j, s in enumerate(ctl.names)},
            "drive": drv.durations_ns()[di].sum(1),
            "busy": (ctl.ts[ci, -1] - ctl.ts[ci, 0])
            + (drv.ts[di, -1] - drv.ts[di, 0]),
            "host": host_ns, "start": np.array([g[1] for g in gc])}


def cycle_ms(ctx, stage: str):
    """Median ms of the control step's ``stage`` over the window's cycles
    (``post``: with the ``drive`` step's stage of the same cycle)."""
    c = api_cycles(ctx)
    if c is None or stage not in c["control"]:
        return None
    ns = c["control"][stage] + (c["drive"] if stage == "post" else 0)
    return float(np.median(ns)) / 1e6


def host_ms(ctx):
    """Median ms of host time in ``get_control`` + ``drive`` less
    ``readback`` over the window's cycles."""
    c = api_cycles(ctx)
    return None if c is None else float(np.median(c["host"])) / 1e6


def api_idle_pct(ctx):
    """100 x (1 - the two graphs' device intervals over the time from each
    ``get_control`` entry to the next), over consecutive window cycles."""
    c = api_cycles(ctx)
    if c is None:
        return None
    nxt = np.flatnonzero(np.diff(c["rid"]) == 1)
    if len(nxt) == 0:
        return None
    period = (c["start"][nxt + 1] - c["start"][nxt]).sum()
    return 100.0 * (1.0 - float(c["busy"][nxt].sum()) / float(period))
