"""The sharded shared-map LiDAR fleet on two gloo ranks on the CPU
(``shared_map_ranks.py``, started and watched by the benchmark's launcher
:func:`benchmark.run.supervise`), held to the plain float64 reference:
every rank's final map equals the map the reference rebuilds from all
lanes' poses, and every compared number lies within the four-card cell's
limits.  A rank whose masks are left unpooled fails; a step pools its
masks in two all-reduces of the map's bytes."""

import os
import socket
import sys

import pytest

from benchmark import run

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "shared_map_ranks.py")


def ranks(fault=""):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmds = [[sys.executable, WORKER, "--rank", str(r), "--world", "2",
             "--port", str(port), "--fault", fault] for r in range(2)]
    return run.supervise(cmds, 0.0, setup_limit=600.0, grace=60.0)


@pytest.fixture(scope="module")
def sound():
    return ranks()


def test_shared_map_matches_the_reference(sound):
    assert sound["ok"], sound["found"]
    gap, _ = sound["found"]["map_gap"]
    assert gap == 0.0
    assert sound["found"]["pose_gap"][0] <= sound["found"]["pose_gap"][1]


def test_counters_count_the_pool(sound):
    steps, cells = sound["steps"], sound["map_cells"]
    assert sound["counts"]["mask_all_reduces"] == 2 * steps
    assert sound["counts"]["mask_pool_bytes"] == 2 * steps * cells


def test_unpooled_rank_fails():
    out = ranks("unpooled")
    assert not out["ok"]
    gap, limit = out["found"]["map_gap"]
    assert gap > limit
