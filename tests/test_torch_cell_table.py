"""The ``cells`` scan's pruned table, ``ops/lidar.CellTable``, on the CPU
(the plain sweep; ``tests/test_torch_cuda.py`` holds kernel K7 to it on
the card).

The per-waypoint rows hold the boundary cells within range + slack of
each waypoint, so a lane whose sensor lies past the slack of its
waypoint, as a lane off the track does, can miss a hit.  The table sends
such a lane to the global table and counts it; a lane within the reach
keeps its row, exactly the work it did before.  Either way the scan finds
the global table's hits, bit for bit."""

import numpy as np
import pytest
import torch

from cell_table_poses import LIDAR, ONE_BEAM, off_track, on_track, sim_track
from multi_purpose_mpc_tpu_torch.ops import lidar as tl
from multi_purpose_mpc_tpu_torch.simulation import resolve_cell_table
from multi_purpose_mpc_tpu_torch.utils import spans


@pytest.fixture(scope="module")
def world():
    grid, path = sim_track()
    table = resolve_cell_table(grid, path, LIDAR, None, "cells")
    return grid, path, table


def _fallbacks():
    return spans.counters().get("cell_table_fallbacks", 0)


def _sweeps(grid, table, lidar, x, y, psi, wp):
    """The sweep over the table, its rows alone (the table with no lane
    past its reach) and the global table."""
    _, cx, cy, ux, uy, sup = tl.cells_prologue(grid, x, y, psi, lidar)
    args = (cx, cy, ux, uy, sup, lidar.range)
    before = _fallbacks()
    got = tl.cells_min_plain(grid, table, wp, *args)
    counted = _fallbacks() - before
    rows = tl.cells_min_plain(grid, table._replace(reach2=float("inf")), wp,
                              *args)
    every = tl.cells_min_plain(grid, table.every, None, *args)
    return got, rows, every, counted, table.fallback(cx, cy, wp)


def _same(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def test_resolve_cell_table_keeps_the_rows_and_adds_the_fallback(world):
    grid, path, table = world
    assert isinstance(table, tl.CellTable)
    cells = tl.occupied_cell_table(grid.occ)
    slack = tl.waypoint_slack(path)
    assert torch.equal(table.rows, tl.waypoint_cell_table(
        cells, grid, path, LIDAR.range + slack))
    assert torch.equal(table.every, cells)
    assert torch.equal(table.waypoints, torch.stack([path.x, path.y], -1))
    reach = slack - float(grid.resolution)
    assert table.reach2 == float(np.float32(reach) * np.float32(reach))
    # the pruning pays: a row is below 3/4 of the global table
    assert table.rows.shape[1] < 0.75 * cells.shape[0]
    # a table given pruned, or not to be pruned, is left as it is
    assert resolve_cell_table(grid, path, LIDAR, table, "cells") is table
    assert resolve_cell_table(grid, path, LIDAR, cells, "cells",
                              prune=False) is cells
    assert resolve_cell_table(grid, path, LIDAR, None, "march") is None


def test_off_track_lanes_fall_back_to_the_global_table(world):
    """Lanes 0.293 m off their waypoint, each beam at a cell past the row:
    the row alone misses hits, the table finds the global table's."""
    grid, path, table = world
    x, y, psi, wp = off_track(grid, path, LIDAR.range
                              + tl.waypoint_slack(path))
    got, rows, every, counted, far = _sweeps(grid, table, ONE_BEAM, x, y,
                                             psi, wp)
    missed = ((rows[0] != every[0]) | (rows[1] != every[1])).any(1)
    assert int(missed.sum()) >= 5 and bool((every[0][missed] < 1.0).all())
    assert bool(far.all()) and counted == len(x)
    assert _same(got, every)


def test_on_track_lanes_keep_their_rows(world):
    """The farthest pose the track allows, its waypoint lagging by one, and
    poses near random waypoints: none falls back, and the sweep is its
    rows' sweep, the global table's bit for bit."""
    grid, path, table = world
    x, y, psi, wp = on_track(grid, path)
    got, rows, every, counted, far = _sweeps(grid, table, LIDAR, x, y, psi,
                                             wp)
    d = torch.hypot(x - path.x[wp.long()], y - path.y[wp.long()])
    assert 0.15 < float(d[0]) < float(d[1]) < table.reach2 ** 0.5
    assert not bool(far.any()) and counted == 0
    assert _same(got, rows) and _same(got, every)
    assert 0.2 < float((every[0] < LIDAR.range).float().mean()) < 1.0


def test_scan_fleet_takes_the_table(world):
    """``scan_fleet(backend="cells")`` with the table: the scans of the
    global table, on and off the track together."""
    grid, path, table = world
    poses = [torch.cat(p) for p in zip(
        off_track(grid, path, LIDAR.range + tl.waypoint_slack(path),
                  waypoints=range(3)), on_track(grid, path, lanes=6))]
    x, y, psi, wp = poses
    got = tl.scan_fleet(grid, x, y, psi, LIDAR, cells=table, backend="cells",
                        wp_id=wp)
    want = tl.scan_fleet(grid, x, y, psi, LIDAR, cells=table.every,
                         backend="cells")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="wp_id"):
        tl.scan_fleet(grid, x, y, psi, LIDAR, cells=table, backend="cells")
