"""The port's recorder (``utils/spans.py``) on the CPU: the host span ring
and the stage ring wrap, the object API's cycle ids and parent slots, one
stage row per step of a rollout, and a rollout under torch.profiler.

On the CPU a stage mark stamps ``perf_counter_ns`` into the layout the
card's ``csrc/stage_clock.cu`` writes ``%globaltimer`` into, so these
rows are read as the benchmark's readers read the card's."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu_torch import api, simulation as tsim
from multi_purpose_mpc_tpu_torch.config import (LidarConfig, SimConfig,
                                                sim_track_preset)
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.utils import maps as tmaps
from multi_purpose_mpc_tpu_torch.utils import profiling, spans
from multi_purpose_mpc_tpu_torch.utils.tree import leaves, tree_map

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "maps")

B, T = 8, 4
FLEET_STAGES = ["locate", "select", "solve", "post"]
LIDAR_STAGES = ["locate", "scan", "writeback", "free_runs", "select",
                "solve", "post"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module")
def world():
    map_cfg, path_cfg, model, cfg, speed, obstacles = sim_track_preset(
        asset_dir=ASSETS)
    bare = tmaps.load_grid_map(map_cfg, device="cpu")
    path = compute_speed_profile(build_reference_path(bare, path_cfg), speed)
    grid = tmaps.add_obstacles_host(bare, map_cfg.origin, map_cfg.resolution,
                                    obstacles)
    wp, ey = tsim.feasible_starts(grid, path, cfg, model, B,
                                  np.random.default_rng(5))
    return dict(grid=grid, path=path, cfg=cfg, model=model,
                map_cfg=map_cfg, path_cfg=path_cfg, speed=speed,
                obstacles=obstacles,
                table=tsim.static_horizon_table(grid, path, cfg, model),
                fleet=tsim.init_fleet(path, cfg.N, B, e_y0=ey, wp_id0=wp))


def _static(w, steps=T, lanes=B, cfg=None):
    fleet = tree_map(lambda x: x[:lanes], w["fleet"])
    return tsim.simulate_fleet(w["grid"], w["path"], cfg or w["cfg"],
                               w["model"], SimConfig(max_steps=steps), fleet,
                               table=w["table"])


def test_host_ring_wraps(monkeypatch):
    """Past its capacity the host ring keeps the latest spans, in the
    order they opened, each with its parent's slot and request id."""
    monkeypatch.setattr(spans, "_host", spans._HostRing(8))
    for _ in range(5):
        with spans.span("outer", spans.next_request("call")):
            with spans.span("inner"):
                pass
    h = spans.host_records()
    assert h.slot.tolist() == list(range(2, 10))
    assert [h.names[i] for i in h.name] == ["outer", "inner"] * 4
    assert h.parent.tolist() == [-1, 2, -1, 4, -1, 6, -1, 8]
    assert h.rid.tolist() == [1, 1, 2, 2, 3, 3, 4, 4]
    assert (h.t1 >= h.t0).all() and not h.profiled.any()


def test_stage_ring_wraps():
    """A ring of 3 rows keeps the last 3 of 5 steps, oldest first, each
    with the request id open when it ran."""
    ring = spans.StageRing("test", 3, "cpu")
    for i in range(5):
        with spans.span("call", spans.next_request("test")):
            with spans.recording(ring):
                spans.stage("a")
                spans.stage("b")
            ring.end()
    t = ring.table()
    assert t.names == ["a", "b"] and t.ts.shape == (3, 3)
    assert t.rid.tolist() == [2, 3, 4] and int(ring.count) == 5
    assert (np.diff(t.ts.reshape(-1)) >= 0).all()
    assert spans.ring("test") is ring


def test_stage_ring_table_checks_the_host_count():
    """A step the device counted and the host did not note (a marked graph
    replayed around ``graphs.Entry.replay``) is refused by the reader."""
    ring = spans.StageRing("test", 4, "cpu")
    with spans.recording(ring):
        spans.stage("a")
    ring.end()
    ring.count += 1
    with pytest.raises(RuntimeError, match="the device counted 2"):
        ring.table()


def test_api_cycles_share_ids_across_get_control_and_drive(world):
    """Each ``get_control`` opens a cycle that the ``drive`` after it
    shares; every child's parent slot is its call's span; the control and
    drive steps each record one stage row a cycle under that id, inside
    their ``step`` child."""
    m = api.Map(world["map_cfg"].file_path, world["map_cfg"].origin,
                world["map_cfg"].resolution, device="cpu")
    pc = world["path_cfg"]
    rp = api.ReferencePath(m, pc.wp_x, pc.wp_y, pc.resolution,
                           pc.smoothing_distance, pc.max_width, pc.circular)
    m.add_obstacles([api.Obstacle(*o) for o in world["obstacles"]])
    cfg, model = world["cfg"], world["model"]
    car = api.BicycleModel(rp, model.length, model.width, model.Ts)
    kmax = np.tan(cfg.delta_max) / car.length
    ctrl = api.MPC(car, cfg.N, np.diag(cfg.Q), np.diag(cfg.R),
                   np.diag(cfg.QN),
                   {"xmin": np.full(3, -np.inf), "xmax": np.full(3, np.inf)},
                   {"umin": np.array([0.0, -kmax]),
                    "umax": np.array([cfg.v_max, kmax])}, cfg.ay_max)
    rp.compute_speed_profile(world["speed"])
    spans.reset()
    for _ in range(2):
        car.drive(ctrl.get_control())
    h = spans.host_records()
    name = [h.names[i] for i in h.name]
    calls = ["get_control", "step", "readback", "unpack",
             "drive", "upload", "step"]
    assert name == calls * 2
    parents = [-1, 0, 0, 0, -1, 4, 4]
    assert h.parent.tolist() == [p if p < 0 else p + c * 7
                                 for c in range(2) for p in parents]
    assert h.rid.tolist() == [0] * 7 + [1] * 7
    ctl, drv = spans.ring("control").table(), spans.ring("drive").table()
    assert ctl.names == ["corridor", "pre_solve", "solve", "post"]
    assert drv.names == ["drive"]
    assert ctl.rid.tolist() == drv.rid.tolist() == [0, 1]
    for c in range(2):
        for row, i in ((ctl.ts[c], 7 * c + 1), (drv.ts[c], 7 * c + 6)):
            assert h.t0[i] <= row[0] <= row[-1] <= h.t1[i]


@pytest.mark.parametrize("kind", ["static", "lidar"])
def test_cpu_rollout_records_a_stage_row_a_step(world, kind):
    """8 lanes x 4 steps: one row a step in the stages' order, each stage
    non-negative, the steps one after the other inside the rollout's
    ``steps`` child."""
    if kind == "static":
        _static(world)
        names = FLEET_STAGES
    else:
        w = world
        known = dataclasses.replace(w["grid"],
                                    occ=torch.ones_like(w["grid"].occ))
        tsim.simulate_lidar_fleet(
            w["grid"], known, w["path"], w["cfg"], w["model"],
            SimConfig(max_steps=T, static_grid=False),
            LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192),
            w["fleet"], scan_backend="cells", writeback_backend="packed")
        names = LIDAR_STAGES
    t = spans.ring("rollout").table()
    assert t.names == names and t.ts.shape == (T, len(names) + 1)
    assert (t.durations_ns() >= 0).all()
    assert (t.ts[1:, 0] >= t.ts[:-1, -1]).all()
    h = spans.host_records()
    name = [h.names[i] for i in h.name]
    assert name == ["rollout", "inputs", "steps"]
    assert t.rid.tolist() == [h.rid[0]] * T
    assert h.t0[2] <= t.ts[0, 0] and t.ts[-1, -1] <= h.t1[2]
    assert t.durations_ns().sum() <= h.t1[2] - h.t0[2]


def test_rollout_under_the_profiler_is_bitwise_the_same(world, tmp_path):
    """A rollout traced by torch.profiler (``profiling.trace``) logs what
    it logs without it, bit for bit; its spans become the trace's host
    ranges, its rows say they were profiled, and ``spans.json`` holds
    both.  (A short solve: the profiler records each of the plain ADMM's
    operations.)"""
    cfg = world["cfg"]
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, iterations=3, rho_updates=1, polish_iters=0))
    plain = _static(world, steps=2, lanes=4, cfg=cfg)
    with profiling.trace(str(tmp_path)):
        traced = _static(world, steps=2, lanes=4, cfg=cfg)
    for a, b in zip(leaves(plain), leaves(traced)):
        assert torch.equal(a, b)
    with open(tmp_path / "trace.json") as f:
        ranges = {e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "cpu_op"}
    assert {"rollout", "inputs", "steps"} <= ranges
    assert spans.ring("rollout").table().profiled.all()
    h = spans.host_records()
    assert h.profiled.tolist() == [False] * 3 + [True] * 3
    with open(tmp_path / "spans.json") as f:
        out = json.load(f)
    rows = out["stages"]["rollout"]["rows"]
    assert out["stages"]["rollout"]["names"] == FLEET_STAGES
    assert len(rows) == 2 and all(r[1] for r in rows)
    assert len(out["spans"]["records"]) == 6
    assert out["counters"]["graph_captures"] >= 0
