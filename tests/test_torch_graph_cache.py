"""The rollout graph cache (``utils/graphs.rollout_cache``) on the CPU.

On the card a rollout is captured once per step, configuration, step
count and layout, and every later call with fresh inputs of the same
shapes copies them in and replays, as ``jax.jit`` reuses a compiled
rollout.  Here the graphs are the stand-in :class:`_EagerGraph` (its
replay runs the captured step's Python again, on the entry's static
copies), with ``should_capture`` patched to True: a step that read a
tensor from a closure instead of its inputs would give the first call's
values on a hit.  Every graphed result is held bit for bit against the
eager form on the same inputs, at B = 4 lanes for 2-3 steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import (LidarConfig, SimConfig,
                                                sim_track_preset)
from multi_purpose_mpc_tpu_torch.mpc import WeightSet
from multi_purpose_mpc_tpu_torch.ops.corridor_extract import build_scanline_table
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.utils import graphs
from multi_purpose_mpc_tpu_torch.utils import maps as tmaps
from multi_purpose_mpc_tpu_torch.utils.tree import leaves, tree_map
from tests.test_torch_rollout import LIDAR, _EagerGraph, _assert_bitwise
from tests.test_torch_setup import ASSETS

B, T = 4, 3
# the second world's extra obstacle (x, y, radius in m) and speed limit
EXTRA_WP, EXTRA_R, V_MAX2 = 60, 0.04, 0.6
# weight rows (Q | R | QN): reference tracking, strictly convex,
# time-optimal pinned, and a heavier tracking row
ROWS = torch.tensor([[1.0, 0.0, 0.0, 0.5, 0.0, 1.0, 0.0, 0.0],
                     [1.0, 0.0, 0.0, 0.5, 0.01, 1.0, 0.0, 0.0],
                     [0.0, 0.0, 0.0, 0.01, 0.01, 0.0, 0.0, 100.0],
                     [2.0, 0.1, 0.0, 0.5, 0.02, 2.0, 0.1, 0.0]])


def _weights(rows):
    rows = ROWS[torch.as_tensor(rows)]
    return WeightSet(Q=rows[:, :3].contiguous(), R=rows[:, 3:5].contiguous(),
                     QN=rows[:, 5:].contiguous())


@pytest.fixture(scope="module")
def worlds():
    """Two Sim_Track worlds of the same shapes: the second has one more
    obstacle on the track, another speed profile, other starts and other
    weights, so that its grid, path, tables, fleet and weights all
    differ from the first's."""
    map_cfg, path_cfg, model, cfg, speed, obstacles = sim_track_preset(
        asset_dir=ASSETS)
    bare = tmaps.load_grid_map(map_cfg, device="cpu")
    centre = build_reference_path(bare, path_cfg)
    extra = (float(centre.x[EXTRA_WP]), float(centre.y[EXTRA_WP]), EXTRA_R)
    out = []
    for i, (obs, v_max) in enumerate(((obstacles, speed.v_max),
                                      (list(obstacles) + [extra], V_MAX2))):
        grid = tmaps.add_obstacles_host(bare, map_cfg.origin,
                                        map_cfg.resolution, obs)
        path = compute_speed_profile(
            centre, dataclasses.replace(speed, v_max=v_max))
        wp, ey = tsim.feasible_starts(grid, path, cfg, model, B,
                                      np.random.default_rng(11 + i))
        out.append(dict(
            grid=grid, path=path,
            table=tsim.static_horizon_table(grid, path, cfg, model),
            scan=build_scanline_table(grid, path, cfg.n_scan_samples),
            fleet=tsim.init_fleet(path, cfg.N, B, e_y0=ey, wp_id0=wp),
            weights=_weights([0, 1, 0, 1] if i == 0 else [2, 3, 3, 2])))
    a, b = out
    for k in ("table", "fleet", "weights"):
        assert any(not torch.equal(x, y) for x, y in zip(
            leaves(a[k]), leaves(b[k]))), k
    assert not torch.equal(a["grid"].occ, b["grid"].occ)
    assert not torch.equal(a["path"].v_ref, b["path"].v_ref)
    return dict(cfg=cfg, model=model, worlds=out)


@pytest.fixture
def graphed(monkeypatch):
    """Rollouts captured with the stand-in graph into a fresh cache;
    ``graphed(run)`` runs ``run()`` so and returns its result and the
    graphs it made."""
    monkeypatch.setattr(graphs, "StepGraph", _EagerGraph)
    monkeypatch.setattr(graphs, "rollout_cache", graphs.GraphCache())

    def run(fn):
        _EagerGraph.made = 0
        with monkeypatch.context() as m:
            m.setattr(graphs, "should_capture", lambda *a, **k: True)
            out = fn()
        return out, _EagerGraph.made

    return run


def _run(path, sc, w, steps=T, cfg=None):
    """One rollout of ``path`` on world ``w``."""
    cfg, model = cfg or sc["cfg"], sc["model"]
    if path in ("static", "sweep"):
        return tsim.simulate_fleet(
            w["grid"], w["path"], cfg, model, SimConfig(max_steps=steps),
            w["fleet"], table=w["table"],
            weights=w["weights"] if path == "sweep" else None)
    if path == "dynamic":
        return tsim.simulate_fleet(
            w["grid"], w["path"], cfg, model,
            SimConfig(max_steps=steps, static_grid=False), w["fleet"],
            table=w["scan"])
    known = dataclasses.replace(w["grid"], occ=torch.ones_like(w["grid"].occ))
    return tsim.simulate_lidar_fleet(
        w["grid"], known, w["path"], cfg, model,
        SimConfig(max_steps=steps, static_grid=False), LidarConfig(**LIDAR),
        w["fleet"], table=w["scan"], weights=w["weights"])


@pytest.mark.parametrize("path", ["static", "sweep", "dynamic", "lidar"])
def test_hit_with_new_inputs_equals_eager(worlds, graphed, path):
    """Call 1 captures (a miss), call 2 on the second world replays the
    same graphs on its copied-in fleet, path, tables, grid and weights (a
    hit): each bitwise equal to the eager form on its own inputs, and
    call 1's results untouched by call 2."""
    w1, w2 = worlds["worlds"]
    eager = [_run(path, worlds, w) for w in (w1, w2)]
    first, made1 = graphed(lambda: _run(path, worlds, w1))
    kept = tree_map(torch.clone, first)
    second, made2 = graphed(lambda: _run(path, worlds, w2))
    assert (made1, made2, len(graphs.rollout_cache)) == (2, 0, 1)
    _assert_bitwise(first, eager[0])
    _assert_bitwise(second, eager[1])
    _assert_bitwise(first, kept)
    assert not torch.equal(first[0].log.x if path == "lidar" else first.log.x,
                           second[0].log.x if path == "lidar"
                           else second.log.x)


def test_new_key_on_a_changed_config_or_steps(worlds, graphed):
    """A changed config or step count captures anew beside the cached
    entries; the first call's key still hits.  Every call bitwise equal
    to the eager form."""
    w = worlds["worlds"][0]
    cfg2 = dataclasses.replace(worlds["cfg"], Q=(2.0, 0.0, 0.0))
    calls = [dict(steps=2), dict(steps=2, cfg=cfg2), dict(steps=3)]
    eager = [_run("static", worlds, w, **kw) for kw in calls]
    made = []
    for i in (0, 1, 2, 0):
        res, n = graphed(lambda: _run("static", worlds, w, **calls[i]))
        _assert_bitwise(res, eager[i])
        made.append(n)
    assert made == [2, 2, 2, 0]
    assert len(graphs.rollout_cache) == 3


def _toy_step(carry, dst, x):
    (v,) = carry
    new = v * x["a"] + x["b"]
    return (new,), (new.sum(0), new[0] > 0)


def _toy(key, a, steps=T):
    """A rollout of a step that reads two inputs, and its eager loop."""
    v0 = (torch.linspace(-1.0, 1.0, 3 * B).reshape(3, B),)
    inputs = dict(a=torch.full((B,), a), b=torch.arange(B, dtype=torch.float32))
    run = lambda: tsim._rollout(_toy_step, v0, steps, inputs=inputs,
                                key=("toy", key))
    state, logs = v0, []
    for _ in range(steps):
        state, log = _toy_step(state, None, inputs)
        logs.append(log)
    return run, (state, tuple(torch.stack(f) for f in zip(*logs)))


def test_eviction_past_the_bound(graphed):
    """The cache keeps ``CACHE_SIZE`` entries a device, least recently
    used out first: a key evicted captures again, a kept one replays."""
    n = graphs.CACHE_SIZE
    for k in range(n + 1):
        run, want = _toy(k, 0.5 + k)
        got, made = graphed(run)
        _assert_bitwise(got, want)
        assert made == 2
    assert len(graphs.rollout_cache) == n
    for k, hit in ((1, True), (0, False)):  # key 0 went first
        run, want = _toy(k, -0.25 * k)
        got, made = graphed(run)
        _assert_bitwise(got, want)
        assert made == (0 if hit else 2)
    assert len(graphs.rollout_cache) == n


def test_clear_cache(graphed):
    """``clear_cache()`` empties the cache; the next call captures."""
    run, want = _toy(0, 0.5)
    assert graphed(run)[1] == 2 and graphed(run)[1] == 0
    graphs.clear_cache()
    assert len(graphs.rollout_cache) == 0
    got, made = graphed(run)
    _assert_bitwise(got, want)
    assert made == 2 and len(graphs.rollout_cache) == 1


def test_failed_capture_raises_and_caches_nothing(graphed, monkeypatch):
    """A capture that fails raises; nothing reruns eagerly in its place
    and nothing is cached."""

    class Broken(_EagerGraph):
        def __init__(self, fn, warmup=None, pool=None):
            raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs, "StepGraph", Broken)
    run, _ = _toy(0, 0.5)
    with pytest.raises(RuntimeError, match="capture failed"):
        graphed(run)
    assert len(graphs.rollout_cache) == 0
