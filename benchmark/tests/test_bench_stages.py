"""The readers of the port's recorder (``step_ms.*``, ``cycle_ms.*``,
``device_idle_pct.api_window``) on a synthetic recorder: a rollout ring,
the object API's two rings and host spans, with known durations."""

import types

import numpy as np
import pytest

from benchmark import drivers, run
from benchmark.metrics import _stages
from multi_purpose_mpc_tpu_torch.utils.spans import HostTable, StageTable

MS = 1_000_000  # ns
STEP = ["locate", "scan", "writeback", "free_runs", "select", "solve",
        "post"]
CONTROL = ["corridor", "pre_solve", "solve", "post"]


def table(names, durations, rid=None, profiled=None, start=0):
    """A StageTable of steps with ``durations`` (steps, stages) ns, each
    step starting 1 ms after the last ended."""
    d = np.asarray(durations, np.int64)
    ts, t = [], start
    for row in d:
        ts.append(np.concatenate([[t], t + np.cumsum(row)]))
        t = ts[-1][-1] + MS
    n = len(d)
    return StageTable(list(names), np.array(ts, np.int64),
                      np.arange(n) if rid is None else np.asarray(rid),
                      np.zeros(n, bool) if profiled is None
                      else np.asarray(profiled))


class Ring:
    def __init__(self, t):
        self.t = t

    def table(self):
        return self.t


def api_recorder(cycles=6, profiled_from=5):
    """Cycles 0..cycles-1, 4 ms apart, the last ones profiled: control
    stages 0.2 / 1.0 / 1.7 / 0.3 ms (+0.1 ms a cycle on the solve), drive
    0.25 ms; get_control 3.0 ms on the host with a 2.0 ms readback, drive
    0.5 ms."""
    prof = [c >= profiled_from for c in range(cycles)]
    ctl = table(CONTROL, [[0.2 * MS, 1.0 * MS, (1.7 + 0.1 * c) * MS,
                           0.3 * MS] for c in range(cycles)], profiled=prof)
    drv = table(["drive"], [[0.25 * MS]] * cycles, profiled=prof)
    names = ["get_control", "readback", "drive"]
    rec = []  # slot, name, parent, rid, t0, t1, profiled
    for c in range(cycles):
        t = 4 * MS * c
        s = len(rec)
        rec += [(s, 0, -1, c, t, t + 3 * MS, prof[c]),
                (s + 1, 1, s, c, t + MS, t + 3 * MS, prof[c]),
                (s + 2, 2, -1, c, t + 3 * MS, t + 3.5 * MS, prof[c])]
    cols = [np.array(c) for c in zip(*rec)]
    host = HostTable(names, *[c.astype(np.int64) for c in cols[:6]],
                     cols[6].astype(bool))
    rings = {"control": Ring(ctl), "drive": Ring(drv)}
    return types.SimpleNamespace(ring=rings.get, host_records=lambda: host)


def ctx(cycles=3):
    window = drivers.Window(1.0, cycles, cycles, cycles, cycles, 0,
                            [0.004] * cycles, [0.003] * cycles)
    return run.Context(trace=None, steps=1, window=window, capture=[],
                       shapes={}, peaks={}, kernels={})


def read(name, c):
    return run.reader(name)(c)


def test_step_ms_mean_over_the_last_call(monkeypatch):
    t = table(STEP, [[1, 2, 3, 4, 5, 6, 7], [3, 2, 1, 2, 3, 2, 1]])
    monkeypatch.setattr(_stages, "recorder", lambda: types.SimpleNamespace(
        ring={"rollout": Ring(t)}.get))
    for i, s in enumerate(STEP):
        want = (t.ts[0, i + 1] - t.ts[0, i] + t.ts[1, i + 1] - t.ts[1, i]) / 2
        assert read(f"step_ms.{s}", ctx()) == pytest.approx(want / MS)


def test_step_ms_of_a_stage_the_step_lacks(monkeypatch):
    t = table(["locate", "select", "solve", "post"], [[1, 2, 3, 4]])
    monkeypatch.setattr(_stages, "recorder", lambda: types.SimpleNamespace(
        ring={"rollout": Ring(t)}.get))
    assert read("step_ms.locate", ctx()) == pytest.approx(1e-6)
    assert read("step_ms.scan", ctx()) is None


def test_cycle_stages_over_the_window_only(monkeypatch):
    """The window's cycles are the last 3 unprofiled ones (2, 3, 4): not
    the warm-up's (0, 1) nor the profiled one (5)."""
    monkeypatch.setattr(_stages, "recorder", api_recorder)
    c = ctx(3)
    assert _stages.api_cycles(c)["rid"].tolist() == [2, 3, 4]
    assert read("cycle_ms.corridor", c) == pytest.approx(0.2)
    assert read("cycle_ms.pre_solve", c) == pytest.approx(1.0)
    assert read("cycle_ms.solve", c) == pytest.approx(2.0)  # 1.9, 2.0, 2.1
    assert read("cycle_ms.post", c) == pytest.approx(0.55)
    # get_control 3.0 + drive 0.5 - readback 2.0
    assert read("cycle_ms.host", c) == pytest.approx(1.5)


def test_api_window_idle(monkeypatch):
    """Cycles 2-4 are 4 ms apart; the graphs run 3.65, 3.75 ms of the two
    periods that start at cycles 2 and 3."""
    monkeypatch.setattr(_stages, "recorder", api_recorder)
    busy = (0.2 + 1.0 + 1.9 + 0.3 + 0.25) + (0.2 + 1.0 + 2.0 + 0.3 + 0.25)
    assert read("device_idle_pct.api_window", ctx(3)) == \
        pytest.approx(100 * (1 - busy / 8.0))
    assert read("device_idle_pct.api_window", ctx(1)) is None


def test_readers_find_nothing(monkeypatch):
    """No recorder (a program without one), no rings, or a window without
    cycles: every reader returns None."""
    names = [f"step_ms.{s}" for s in STEP] + [
        f"cycle_ms.{s}" for s in CONTROL + ["host"]] + [
        "device_idle_pct.api_window"]
    for rec in (lambda: None,
                lambda: types.SimpleNamespace(ring=lambda _: None)):
        monkeypatch.setattr(_stages, "recorder", rec)
        for n in names:
            assert read(n, ctx()) is None, n
    monkeypatch.setattr(_stages, "recorder", api_recorder)
    for n in names[len(STEP):]:
        assert read(n, ctx(0)) is None, n
