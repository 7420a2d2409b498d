"""A cell on several cards, on the CPU: two gloo ranks of the
``shared_lidar_fleet`` kind (traffic ``shared_map_x4``, limits
``sim_track.shared_map_x4``; no cell of ``BENCHMARK.json`` yet) at a small
size (``shared_ranks.py``), started and watched by the launcher of
``benchmark/run.py`` (:func:`benchmark.run.supervise`).  The program is correct and the
bfloat16 control is not; each fault planted in the timed path fails the
check (a rank's masks left unpooled, half a rank's lanes left out of the
gathered log, a state left unchanged, an answer altered); a rank that
exits, or stops, in the window makes the command fail with no result
within its deadline."""

import json
import os
import socket
import sys
import time

import pytest

from benchmark import run

WORKER = os.path.join(run.HERE, "tests", "shared_ranks.py")
CELL = "sim_track.shared_map_x4"


def commands(fault="", control=False):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [[sys.executable, WORKER, "--rank", str(r), "--world", "2",
             "--port", str(port), "--fault", fault]
            + (["--control"] if control else []) for r in range(2)]


def ranks(fault="", control=False, grace=60.0):
    return run.supervise(commands(fault, control), 0.0, setup_limit=600.0,
                         grace=grace)


@pytest.fixture(scope="module")
def sound():
    return ranks(control=True)


def test_shared_cell_is_correct(sound):
    assert sound["sound"]["ok"], sound["sound"]["found"]


def test_control_is_not_correct(sound):
    assert not sound["control"]["ok"], sound["control"]["found"]


@pytest.mark.parametrize("fault", ["unpooled", "half", "still", "altered"])
def test_fault_is_not_correct(fault):
    out = ranks(fault)["sound"]
    assert not out["ok"], (fault, out["found"])
    if fault == "unpooled":  # the exchange between the cards
        gap, limit = out["found"]["map_gap"]
        assert gap > limit


@pytest.fixture
def with_cell(tmp_path, monkeypatch):
    """``BENCHMARK.json`` with the kind's four-card cell added, in place of
    the manifest that ``run.py`` reads."""
    manifest = run.load_json(run.MANIFEST)
    manifest["workloads"].append({
        "name": CELL, "config": "sim_track", "traffic": "shared_map_x4",
        "chips": 4, "why": "the shared_lidar_fleet kind on four cards"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    monkeypatch.setattr(run, "MANIFEST", str(path))


def test_rank_exit_fails_with_no_result(with_cell, monkeypatch, capsys):
    """The command of a cell on several cards, its ranks replaced by the
    CPU worker whose rank 1 exits in the window."""
    t0 = time.monotonic()
    real = run.supervise
    monkeypatch.setattr(run, "cards", lambda cell: None)
    monkeypatch.setattr(run, "supervise", lambda cmds, seconds: real(
        commands("exit"), seconds, 600.0, 60.0))
    rc = run.main(["--workload", CELL, "--seed", "2147483659", "--seconds",
                   "0"])
    assert rc != 0
    assert capsys.readouterr().out.strip() == ""
    assert time.monotonic() - t0 < 120


def test_stopped_rank_is_killed_past_the_window():
    t0 = time.monotonic()
    with pytest.raises(run.Fail, match="deadline"):
        ranks("hang", grace=5.0)
    assert time.monotonic() - t0 < 120


def test_four_card_cell_without_cards_fails(with_cell, monkeypatch, capsys):
    """Without the cards, the launcher fails before it starts a rank."""
    monkeypatch.setattr(run, "launch", lambda *a: pytest.fail("launched"))
    rc = run.main(["--workload", CELL, "--seed", "2147483659", "--seconds",
                   "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "CUDA" in out.err
