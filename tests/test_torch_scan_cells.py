"""The sweep of the ``cells`` LiDAR scan, ``ops/lidar.cells_min_plain`` (the
plain version of kernel K7), on the CPU.

* (a) every real row of the cell tables is in strictly ascending packed-id
  order ``py * W + px``, the dummies last.  That is what makes the plain
  version's chunked rule (the first chunk's winner, the smallest id within
  a chunk) the lexicographic ``(d, pid)`` minimum that K7 computes.
* (b) ``cells_min_plain`` equals a brute-force numpy float32 lexicographic
  minimum over all cells, with no chunking, bit for bit: on Sim_Track's
  global and per-waypoint tables, and on ``scan_ties.tie_world``, whose
  poses meet exact distance ties between two cells on one beam.  Numpy
  rounds every float32 operation as the plain version does, so the bar is
  equality (the square root is torch's, which the plain version takes).
* (c) ``scan_fleet(backend="cells")`` on CPU tensors takes the plain
  version, never the kernel, and still meets the bars of
  tests/test_torch_lidar.py::test_scan_vs_jax against the JAX package.
"""

import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu_torch.ops import lidar as tl
from scan_ties import LIDAR as TIE_LIDAR
from scan_ties import tie_world
from tests.test_torch_lidar import sc  # noqa: F401  (the Sim_Track fixture)
from tests.test_torch_lidar import test_scan_vs_jax as _held_to_jax

MID = (TIE_LIDAR.n_beams - 1) // 2  # the beam at relative angle 0


@pytest.fixture(scope="module")
def ties():
    return tie_world("cpu")


def _nearest_wp(path, x, y):
    return torch.tensor([int(torch.argmin((path.x - a) ** 2 + (path.y - b) ** 2))
                         for a, b in zip(x, y)], dtype=torch.int32)


def _world(sc, ties, world, table):
    """``(grid, cells, wp_id, cx, cy, ux, uy, support, range)``."""
    if world == "ties":
        w = ties
        cells = w["wpc"] if table == "per_waypoint" else w["cells"]
        return (w["grid"], cells, w["wp_id"], w["cx"], w["cy"], w["ux"],
                w["uy"], w["support"], TIE_LIDAR.range)
    grid, cfg = sc["tgrid"], sc["tcfg"]
    x, y, psi = sc["tpose"]
    _, cx, cy, ux, uy, support = tl.cells_prologue(grid, x, y, psi, cfg)
    cells = sc["twpc"] if table == "per_waypoint" else sc["tcells"]
    return (grid, cells, _nearest_wp(sc["tpath"], x, y), cx, cy, ux, uy,
            support, cfg.range)


def _brute(grid, cells, wp_id, cx, cy, ux, uy, support, rng):
    """Lexicographic ``(d, pid)`` minimum over every cell of each lane's
    row, one lane at a time, in numpy float32; also the count of beams
    whose minimum distance two or more passing cells share."""
    f32 = np.float32
    res = f32(grid.resolution.item())
    ox, oy = (f32(v) for v in grid.origin.numpy())
    W = grid.occ.shape[1]
    if isinstance(cells, tl.CellTable):  # a lane's row, or every cell
        far = cells.fallback(cx, cy, wp_id).numpy()
        rows, every = cells.rows.numpy(), cells.every.numpy()
        row_of = lambda b: every if far[b] else rows[int(wp_id[b])]
    else:
        row_of = lambda b: cells.numpy()
    cx, cy, ux, uy, sup = (t.numpy() for t in (cx, cy, ux, uy, support))
    B, nb = ux.shape
    out_d = np.full((B, nb), 1e9, f32)
    out_p = np.full((B, nb), 1e9, f32)
    ties = 0
    for b in range(B):
        row = row_of(b)
        px, py = row[:, 0], row[:, 1]
        gx = (px.astype(f32) + f32(0.5)) * res + ox
        gy = (py.astype(f32) + f32(0.5)) * res + oy
        with np.errstate(over="ignore"):  # dummies' ids wrap, as in torch
            pid = (py * np.int32(W) + px).astype(f32)
        dx, dy = gx - cx[b], gy - cy[b]
        # torch's sqrt: on the CPU it is not always correctly rounded (one
        # ulp below numpy's on ~2 % of the tie world's cells); on the card
        # it is IEEE's, as K7's
        d = torch.sqrt(torch.from_numpy(dx * dx + dy * dy)).numpy()
        ok = (d < f32(rng)) & (d > 0)
        along = dx[:, None] * ux[b] + dy[:, None] * uy[b]
        perp = np.abs(dy[:, None] * ux[b] - dx[:, None] * uy[b])
        hit = (along > 0) & (perp <= sup[b]) & ok[:, None]
        dmin = np.where(hit, d[:, None], np.inf).min(0)
        at = hit & (d[:, None] == dmin)
        found = np.isfinite(dmin)
        out_d[b] = np.where(found, dmin, f32(1e9))
        out_p[b] = np.where(found, np.where(at, pid[:, None], np.inf).min(0),
                            f32(1e9))
        ties += int((at.sum(0) >= 2).sum())
    return out_d, out_p, ties


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("table", ["global", "per_waypoint"])
@pytest.mark.parametrize("world", ["sim_track", "ties"])
def test_cell_tables_ascending_dummies_last(sc, ties, world, table):
    """(a) each table row: real cells first, in strictly ascending packed id,
    then (-10**6, -10**6) dummies only."""
    grid, cells = _world(sc, ties, world, table)[:2]
    W = grid.occ.shape[1]
    rows = (cells.numpy()[None] if table == "global" else cells.rows.numpy())
    for row in rows:
        real = row[:, 0] > -(10 ** 5)
        n = int(real.sum())
        assert n > 0 and real[:n].all()
        assert (row[n:] == -(10 ** 6)).all()
        ids = row[:n, 1].astype(np.int64) * W + row[:n, 0]
        assert (np.diff(ids) > 0).all()


@pytest.mark.parametrize("table", ["global", "per_waypoint"])
@pytest.mark.parametrize("world", ["sim_track", "ties"])
def test_cells_min_plain_equals_brute_force(sc, ties, world, table):
    """(b) the plain version, at its defaults and chunked raggedly (300
    cells of 5 lanes at a time), bitwise the brute-force minimum; in the
    tie world every pose's middle beam meets a tie, won by the smaller id
    (the cell (sx + 2, sy + 1))."""
    args = _world(sc, ties, world, table)
    want_d, want_p, n_ties = _brute(*args)
    nb = args[5].shape[1]  # ux (B, nb)
    for kw in ({}, dict(chunk=300, max_elems=5 * 300 * nb)):
        got_d, got_p = tl.cells_min_plain(*args, **kw)
        assert got_d.dtype == got_p.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got_d.numpy()), _bits(want_d))
        np.testing.assert_array_equal(_bits(got_p.numpy()), _bits(want_p))
    hits = want_d < args[-1]
    assert 0.2 < hits.mean() < 1.0
    if world == "ties":
        grid, W = args[0], args[0].occ.shape[1]
        assert n_ties >= len(want_d)
        res = float(grid.resolution)
        sx = np.floor((ties["x"].numpy() - grid.origin[0].item()) / res)
        sy = np.floor((ties["y"].numpy() - grid.origin[1].item()) / res)
        np.testing.assert_array_equal(want_p[:, MID], (sy + 1) * W + sx + 2)
        np.testing.assert_array_equal(want_d[:, MID],
                                      np.float32(np.sqrt(np.float32(5))
                                                 * np.float32(res)))


@pytest.mark.parametrize("backend", ["cells", "cells_pruned"])
def test_scan_fleet_cells_on_cpu_takes_plain_version(sc, backend,
                                                     monkeypatch):
    """(c) on CPU tensors the sweep is the plain version, once a scan, and
    the scan meets test_scan_vs_jax's bars against the JAX package."""
    calls = []
    plain = tl.cells_min_plain

    def spy(*args, **kw):
        table = args[1]  # a CellTable's rows are per waypoint: 3-D
        calls.append((table.rows if isinstance(table, tl.CellTable)
                      else table).dim())
        return plain(*args, **kw)

    monkeypatch.setattr(tl, "cells_min_plain", spy)
    launches = tl.cells_min_cuda.launches
    _held_to_jax(sc, backend)
    assert calls == [2 if backend == "cells" else 3]
    assert tl.cells_min_cuda.launches == launches
