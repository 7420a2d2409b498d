"""Synthetic horizon blocks (B, N, F) for corridor selection (kernel K2),
F = 7 + 5 S + 3: pose columns, S upper and S lower border points, S valid
flags, 3 solver columns.  Made with numpy from a seed; no JAX, so the CUDA
tests on the GPU can use them too.

:func:`random_blocks`: lanes on curving paths, borders along the normal,
about 70 % of the segments valid.

:func:`edge_blocks`: lane ``b`` is of kind ``b % 6``:

0. exact score ties whose candidates differ in output: the waypoint at the
   origin with heading 0 and no forward projection, integer geometry and a
   safety margin of 0.5, so every score is exact: at n = 0 several
   segments of the same width, at odd n several at the same mean distance
   (Pythagorean offsets 5 + 3, 3 + 5, 4 + 4) from the projected borders of
   the stage before, whose candidates all sit at distance 5 (even n) or
   which is the first widest one (n = 0); the first valid one must win;
1. zero-width segments (upper point = lower point) with -0 and +0
   coordinates, and a few NaN valid flags;
2. random stages with no valid segment;
3. a lane with no valid segment at any stage;
4. a NaN lane (every column NaN);
5. a random lane with one valid segment a stage carrying a NaN point.
"""

import numpy as np

NPOSE = 7
SM_EXACT = 0.5  # the safety margin that keeps kind 0's arithmetic exact


def width(S: int) -> int:
    return NPOSE + 5 * S + 3


def _random_lane(rng, N, S):
    """(N, F) float64: a curving path, borders along the normal."""
    lane = np.zeros((N, width(S)))
    psi = np.cumsum(rng.normal(0.0, 0.15, N)) + rng.uniform(-np.pi, np.pi)
    ds = rng.uniform(0.03, 0.08, N)
    x = np.cumsum(ds * np.cos(psi)) + rng.uniform(-2, 2)
    y = np.cumsum(ds * np.sin(psi)) + rng.uniform(-2, 2)
    prev = np.concatenate([psi[:1], psi[:-1]])
    lane[:, :NPOSE] = np.stack([x, y, np.cos(psi), np.sin(psi), ds,
                                np.cos(prev), np.sin(prev)], -1)
    nx, ny = -np.sin(psi)[:, None], np.cos(psi)[:, None]
    tx, ty = np.cos(psi)[:, None], np.sin(psi)[:, None]
    wu = rng.uniform(-0.2, 1.2, (N, S))
    wl = wu - rng.uniform(0.2, 2.0, (N, S))
    along = rng.uniform(-0.02, 0.02, (N, S, 2))
    ub = np.stack([x[:, None] + wu * nx + along[..., 0] * tx,
                   y[:, None] + wu * ny + along[..., 0] * ty], -1)
    lb = np.stack([x[:, None] + wl * nx + along[..., 1] * tx,
                   y[:, None] + wl * ny + along[..., 1] * ty], -1)
    lane[:, NPOSE:NPOSE + 2 * S] = ub.reshape(N, 2 * S)
    lane[:, NPOSE + 2 * S:NPOSE + 4 * S] = lb.reshape(N, 2 * S)
    lane[:, NPOSE + 4 * S:NPOSE + 5 * S] = rng.random((N, S)) < 0.7
    lane[:, -3:] = rng.uniform(0.1, 1.0, (N, 3))
    return lane


def random_blocks(B: int, N: int, S: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([_random_lane(rng, N, S) for _ in range(B)]
                    ).astype(np.float32)


# Pythagorean offsets by length, upper points above and lower points below
_UP = {3: [(0, 3), (3, 0), (-3, 0)], 4: [(0, 4), (4, 0), (-4, 0)],
       5: [(0, 5), (3, 4), (4, 3), (-3, 4), (-4, 3)]}
_TIES = ((5, 3), (3, 5), (4, 4))  # (|upper offset|, |lower offset|): mean 4


def _tie_lane(rng, N, S):
    """Kind 0 (module docstring): exact ties at n = 0 and at odd n."""
    lane = np.zeros((N, width(S)))
    lane[:, 2] = lane[:, 5] = 1.0  # heading 0 at every stage, ds = 0
    ub = np.zeros((N, S, 2))
    lb = np.zeros((N, S, 2))
    valid = (rng.random((N, S)) < 0.8).astype(float)
    valid[:, :min(S, 2)] = 1.0  # at least two tied candidates where S > 1
    first = np.zeros(N, int)
    for n in range(N):
        order = rng.permutation(S)
        valid[n] = valid[n, order]
        first[n] = int(np.flatnonzero(valid[n] > 0.5)[0])
        for s in range(S):
            if n == 0:  # width 10, the segment slid along the normal
                up = 5 + (s % 4)
                ub[n, s], lb[n, s] = (0, up), (0, up - 10)
            elif n % 2 == 0:  # every candidate at distance 5 from the waypoint
                u, v = _UP[5][rng.integers(len(_UP[5]))], _UP[5][rng.integers(len(_UP[5]))]
                ub[n, s], lb[n, s] = u, (v[0], -v[1])
            else:  # mean distance 4 from the projected borders (0, U), (0, -L)
                U = np.hypot(*ub[n - 1, first[n - 1]])
                L = np.hypot(*lb[n - 1, first[n - 1]])
                du, dl = _TIES[s % len(_TIES)]
                u = _UP[du][rng.integers(len(_UP[du]))]
                v = _UP[dl][rng.integers(len(_UP[dl]))]
                ub[n, s] = (u[0], U + u[1])
                lb[n, s] = (v[0], -L - v[1])
    lane[:, NPOSE:NPOSE + 2 * S] = ub.reshape(N, 2 * S)
    lane[:, NPOSE + 2 * S:NPOSE + 4 * S] = lb.reshape(N, 2 * S)
    lane[:, NPOSE + 4 * S:NPOSE + 5 * S] = valid
    lane[:, -3:] = 0.5
    return lane


def edge_blocks(B: int, N: int, S: int, seed: int = 0) -> np.ndarray:
    """Lanes of the six kinds of the module docstring, in turn."""
    rng = np.random.default_rng(seed)
    va0 = NPOSE + 4 * S
    lanes = []
    for b in range(B):
        kind = b % 6
        if kind == 0:
            lanes.append(_tie_lane(rng, N, S))
            continue
        lane = _random_lane(rng, N, S)
        if kind == 1:
            pts = lane[:, NPOSE:NPOSE + 2 * S]
            lane[:, NPOSE + 2 * S:NPOSE + 4 * S] = pts  # zero width
            lane[0, NPOSE:NPOSE + 4 * S] = np.where(
                rng.random(4 * S) < 0.5, -0.0, 0.0)
            lane[0, :2] = 0.0
            nan_flags = rng.random((N, S)) < 0.1
            lane[:, va0:va0 + S][nan_flags] = np.nan
        elif kind == 2:
            lane[rng.random(N) < 0.4, va0:va0 + S] = 0.0
        elif kind == 3:
            lane[:, va0:va0 + S] = 0.0
        elif kind == 4:
            lane[:] = np.nan
        else:
            s = rng.integers(0, S, N)
            lane[np.arange(N), va0 + s] = 1.0
            lane[np.arange(N), NPOSE + 2 * s + rng.integers(0, 2, N)] = np.nan
        lanes.append(lane)
    return np.stack(lanes).astype(np.float32)
