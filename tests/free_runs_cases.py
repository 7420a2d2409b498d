"""Scanlines built to try the free runs (kernel K8 and its plain version).

``pattern(name, K, rng)`` gives one row of extracted values for each of
:data:`PATTERNS`: random 0/1 at free shares 0.1, 0.5 and 0.9, random
floats in [0, 1] (with exact 0.5, a value the ``> 0.5`` test must
reject), all free, all occupied, runs that touch sample 0 and sample
K - 1, single free samples, and alternating samples, more runs than
segment slots.  ``case(...)`` lays them over
(B, N) scanlines on a table of its own: random endpoints, some samples out
of bounds (``inb`` false), and, with ``ties``, every run's endpoints set so
that its width meets ``min_width`` exactly or within an ulp.

Ties: a run's upper endpoint is (0, 0) and its lower one (-dx, -dy), so
the plain version's differences are exactly (dx, dy).  ``TIE_WIDTH`` =
5 / 128 is exact in float32, and (3 / 128, 4 / 128) lies exactly on it;
(w, 0), (0, w) and their float32 neighbours lie on or beside it; (r cos t,
r sin t) in float32, r a few ulps off w either way, lie within an ulp or
two of it, where the hypot's rounding decides.  Runs are at least two
samples apart there, so no sample is the endpoint of two runs.

Imports no JAX: ``tests/test_torch_dynamic.py`` uses it on the CPU,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.ops.corridor_extract import ScanlineTable

TIE_WIDTH = 5.0 / 128
PATTERNS = ("free_0.1", "free_0.5", "free_0.9", "uniform", "all_free",
            "all_occupied", "edges", "singles", "alternating")


def pattern(name: str, K: int, rng) -> np.ndarray:
    """One (K,) float32 row of extracted values."""
    if name.startswith("free_"):
        return (rng.random(K) < float(name[5:])).astype(np.float32)
    if name == "uniform":
        v = rng.random(K).astype(np.float32)
        v[rng.integers(0, K, 4)] = 0.5
        return v
    row = np.zeros(K, np.float32)
    if name == "all_free":
        row[:] = 1.0
    elif name == "edges":  # runs from sample 0 and to sample K - 1
        row[: K // 4] = 1.0
        row[K - K // 4:] = 1.0
        row[K // 2] = 1.0
    elif name == "singles":
        row[::3] = 1.0
    elif name == "alternating":
        row[::2] = 1.0
    return row


def tie_row(K: int) -> np.ndarray:
    """Free runs of two samples, three apart: every run's endpoints are
    samples of its own."""
    row = np.zeros(K, np.float32)
    for s in range(1, K - 2, 5):
        row[s:s + 2] = 1.0
    return row


def _tie_steps(w: float, rng, n: int) -> np.ndarray:
    f = np.float32
    w32 = f(w)
    up, down = np.nextafter(w32, f(1)), np.nextafter(w32, f(0))
    fixed = [(w32, 0), (0, w32), (up, 0), (down, 0), (0, up), (0, down)]
    if w == TIE_WIDTH:
        fixed += [(3 / 128, 4 / 128), (4 / 128, 3 / 128)]
    t = rng.uniform(0, np.pi / 2, n)
    r = w * (1.0 + rng.integers(-3, 4, n) * 2.0 ** -24)
    polar = np.stack([r * np.cos(t), r * np.sin(t)], 1)
    steps = np.concatenate([np.array(fixed, np.float64), polar])
    return steps.astype(np.float32)


def case(B: int, N: int, K: int, seed: int, ties: bool = False,
         min_width: float = TIE_WIDTH, device="cpu"):
    """``(vals (B, N, K), table, idx (B, N))`` on ``device``: every
    scanline its own table row (in shuffled order); without ``ties``,
    :data:`PATTERNS` in turn over the scanlines, random endpoints and 5 %
    of the samples out of bounds; with ``ties``, :func:`tie_row` on every
    scanline, every sample in bounds and the endpoints of :func:`_tie_steps`
    for ``min_width``."""
    rng = np.random.default_rng(seed)
    L = B * N
    if ties:
        vals = np.broadcast_to(tie_row(K), (L, K)).copy()
        inb = np.ones((L, K), bool)
        cx = rng.normal(size=(L, K)).astype(np.float32)
        cy = rng.normal(size=(L, K)).astype(np.float32)
        steps = _tie_steps(min_width, rng, 4 * L)
        j = 0
        for line in range(L):
            row = vals[line] > 0.5
            for s in np.flatnonzero(row & ~np.r_[False, row[:-1]]):
                e = s + 1
                cx[line, s - 1] = cy[line, s - 1] = 0.0
                cx[line, e + 1], cy[line, e + 1] = -steps[j % len(steps)]
                j += 1
    else:
        vals = np.stack([pattern(PATTERNS[i % len(PATTERNS)], K, rng)
                         for i in range(L)])
        inb = rng.random((L, K)) >= 0.05
        cx = rng.normal(scale=0.05, size=(L, K)).astype(np.float32)
        cy = rng.normal(scale=0.05, size=(L, K)).astype(np.float32)
    perm = rng.permutation(L)
    t = lambda a, dt=None: torch.tensor(a, dtype=dt, device=device)
    # scanline i reads table row perm[i]
    table = ScanlineTable(
        px=t(np.zeros((L, K), np.int32)), py=t(np.zeros((L, K), np.int32)),
        inb=t(inb[np.argsort(perm)]), cx=t(cx[np.argsort(perm)]),
        cy=t(cy[np.argsort(perm)]))
    return (t(vals.reshape(B, N, K)), table,
            t(perm.reshape(B, N), torch.int64))
