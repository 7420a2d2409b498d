"""The port's CUDA kernels against their plain twins, on the GPU.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tests marked ``cuda`` need an NVIDIA GPU and nvcc; they skip elsewhere
(the decision is made inside the fixture, never at import).  The rest pin
the CPU-side contract of the wrappers and the build.
"""

import contextlib
import dataclasses
import os
import shutil
import time

import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu_torch.config import (LidarConfig, SimConfig,
                                                SolverConfig,
                                                sim_track_preset)
from multi_purpose_mpc_tpu_torch.mpc import (WeightSet, kappa_predictions,
                                             mpc_locate, mpc_pre_solve)
from multi_purpose_mpc_tpu_torch.ops import (admm_cuda, corridor_cuda,
                                             corridor_extract, lidar,
                                             mapping)
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
    gather_horizon_block, solver_inputs_from_block)
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import (StageQP,
                                                    init_solver_carry,
                                                    pack_qp)
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.simulation import (_locate_horizon,
                                                    init_fleet,
                                                    simulate_fleet,
                                                    simulate_lidar_fleet,
                                                    static_horizon_table)
from multi_purpose_mpc_tpu_torch.utils import graphs, kernels
from multi_purpose_mpc_tpu_torch.utils.maps import (add_obstacles_host,
                                                    load_grid_map)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "maps")


def _scenario(device, B=256, seed=0):
    """Sim_Track on ``device`` with B random starts (some off-corridor)."""
    map_cfg, path_cfg, model, cfg, speed_cfg, obstacles = sim_track_preset(ASSETS)
    grid = load_grid_map(map_cfg, device=device)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed_cfg)
    table = static_horizon_table(grid, path, cfg, model)
    rng = np.random.default_rng(seed)
    fleet = init_fleet(
        path, cfg.N, B,
        e_y0=torch.tensor(rng.uniform(-0.06, 0.06, B), dtype=torch.float32,
                          device=device),
        wp_id0=torch.tensor(rng.integers(0, path.n_wp, B), dtype=torch.int32,
                            device=device))
    wp, e_y, e_psi = mpc_locate(fleet, path)
    blk = gather_horizon_block(table, wp)
    return dict(grid=grid, path=path, table=table, fleet=fleet, blk=blk,
                e_y=e_y, e_psi=e_psi, model=model, cfg=cfg)


def _k1_args(sc, corridor):
    v, k, ds = solver_inputs_from_block(sc["blk"], sc["cfg"].max_segments)
    x0 = torch.stack([sc["e_y"], sc["e_psi"], torch.zeros_like(sc["e_y"])], -1)
    kp = kappa_predictions(sc["fleet"].u_seq, sc["cfg"].N)
    return (v, k, ds, corridor.lb, corridor.ub, x0, kp, sc["fleet"].solver,
            sc["cfg"].solver, sc["cfg"], sc["model"])


@pytest.fixture(scope="module")
def cuda_sc():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return _scenario(torch.device("cuda:0"))


def test_library_path_is_keyed_by_source(tmp_path, monkeypatch):
    p = kernels.library_path("admm_fused")
    assert p.parent.parent == kernels.BUILD_DIR and p.name == "libadmm_fused.so"
    assert len(p.parent.name) == 16
    assert kernels.library_path("admm_fused") == p
    assert kernels.library_path("corridor_select").parent != p.parent
    # an edited shared header changes the key of every kernel built with it
    src = tmp_path / "csrc"
    shutil.copytree(kernels.SRC_DIR, src)
    monkeypatch.setattr(kernels, "SRC_DIR", src)
    before = {n: kernels.library_path(n)
              for n in ("admm_fused", "admm_structured")}
    assert before["admm_fused"] == p
    with open(src / "admm_core.cuh", "a") as f:
        f.write("// edited\n")
    for name, path in before.items():
        assert kernels.library_path(name) != path, name


def test_launch_check_raises():
    kernels.check_launch(0, "k")
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        kernels.check_launch(9, "k")


def test_cr_lane_layout_fits_sixteen_lanes_per_sm():
    """The CR lane mirrors csrc/admm_core.cuh (lane_floats): 61 floats a
    stage, 25 + 5 a padded stage, 15 + 15 an odd stage of any level, the
    total rounded up to 16 bytes; the Schur lane is unchanged.  At N = 30
    two blocks of eight CR lanes, with 1 KB each for the runtime, fit in
    an SM's 233,472 bytes of shared memory."""
    from multi_purpose_mpc_tpu_torch.ops.cyclic_reduction import padded_stages

    for N in (1, 2, 7, 8, 30, 31, 60, 255, admm_cuda.N_MAX_CR):
        S, M = N + 1, padded_stages(N + 1)
        levels = M.bit_length()  # log2(M + 1)
        floats = 61 * S + (25 + 5) * M + (15 + 15) * (M - levels)
        assert admm_cuda.lane_smem_bytes(N, True) == 4 * (-(-floats // 4) * 4)
    assert admm_cuda.lane_smem_bytes(30, True) == 14416
    assert 2 * (8 * 14416 + 1024) <= 233472 < 4 * (4 * 14416 + 1024)
    assert admm_cuda.N_MAX_CR == 453
    assert admm_cuda.lane_smem_bytes(453, True) <= 232448 \
        < admm_cuda.lane_smem_bytes(454, True)
    assert admm_cuda.lane_smem_bytes(30) == 13536 and admm_cuda.N_MAX == 532


def test_cuda_wrappers_refuse_cpu_tensors():
    blk = torch.zeros((2, 30, corridor_cuda.block_width(8)))
    with pytest.raises(ValueError):
        corridor_cuda.corridor_select_cuda(blk, 8, 0.04)
    z = torch.zeros((2, 30))
    with pytest.raises(ValueError):
        admm_cuda.solve_mpc_qp_fused_cuda(
            z, z, z, z, z, torch.zeros((2, 3)), z,
            init_solver_carry(30, 2, device="cpu"),
            sim_track_preset()[3].solver, sim_track_preset()[3],
            sim_track_preset()[2])
    sq = StageQP(AB=torch.zeros((2, 30, 3, 5)),
                 beq=torch.zeros((2, 31, 3)), Pd=torch.zeros((2, 31, 5)),
                 qv=torch.zeros((2, 31, 5)), lw=torch.zeros((2, 31, 5)),
                 uw=torch.zeros((2, 31, 5)))
    with pytest.raises(ValueError):
        admm_cuda.solve_ltv_qp_structured_cuda(
            sq, init_solver_carry(30, 2, device="cpu"),
            sim_track_preset()[3].solver)
    pxy = torch.zeros((2, 30, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        corridor_extract.extract_occ_cuda(torch.ones((500, 500)), pxy, pxy)
    from scan_ties import tie_world

    w = tie_world("cpu", lanes=2)
    with pytest.raises(ValueError):
        lidar.cells_min_cuda(w["grid"], w["wpc"], w["wp_id"], w["cx"],
                             w["cy"], w["ux"], w["uy"], w["support"], 1.0)
    from free_runs_cases import case

    with pytest.raises(ValueError):
        corridor_extract.free_runs_cuda(*case(2, 3, 128, seed=0), 0.04, 8)


@pytest.mark.cuda
def test_k2_kernel_bitwise_equals_twin(cuda_sc):
    S, sm = cuda_sc["cfg"].max_segments, cuda_sc["model"].safety_margin
    ker = corridor_cuda.corridor_select_cuda(cuda_sc["blk"], S, sm)
    ref = corridor_cuda.corridor_select_plain(cuda_sc["blk"], S, sm)
    torch.cuda.synchronize()
    for a, b in zip(ker, ref):
        assert torch.equal(a, b)
    assert corridor_cuda.corridor_select(cuda_sc["blk"], S, sm).ub.is_cuda


@pytest.mark.cuda
def test_k1_kernel_matches_twin(cuda_sc):
    S, sm = cuda_sc["cfg"].max_segments, cuda_sc["model"].safety_margin
    cor = corridor_cuda.corridor_select_plain(cuda_sc["blk"], S, sm)
    args = _k1_args(cuda_sc, cor)
    cfg = cuda_sc["cfg"]
    sol_k, fl_k = admm_cuda.finish(admm_cuda.solve_mpc_qp_fused_cuda(*args),
                                   args[0], args[1], args[3], args[4],
                                   cfg.solver, cfg)
    sol_p, fl_p = admm_cuda.finish(admm_cuda.solve_mpc_qp_fused_plain(*args),
                                   args[0], args[1], args[3], args[4],
                                   cfg.solver, cfg)
    torch.cuda.synchronize()
    assert (sol_k.status == sol_p.status).float().mean() >= 0.995
    assert float((sol_k.r_prim - sol_p.r_prim).abs().max()) <= 1e-4
    acc = (sol_k.r_prim <= cfg.feas_tol) & (sol_p.r_prim <= cfg.feas_tol)
    assert float((sol_k.U[:, 0] - sol_p.U[:, 0]).abs()[acc].max()) <= 3e-3
    assert float((fl_k - fl_p).abs().max()) <= 1e-6
    assert (fl_k > 0).any()


@pytest.mark.cuda
def test_cuda_wrappers_validate_inputs(cuda_sc):
    S, sm = cuda_sc["cfg"].max_segments, cuda_sc["model"].safety_margin
    blk = cuda_sc["blk"]
    with pytest.raises(ValueError):
        corridor_cuda.corridor_select_cuda(blk.double(), S, sm)
    with pytest.raises(ValueError):
        corridor_cuda.corridor_select_cuda(blk[:, :, :-1], S, sm)
    with pytest.raises(ValueError):
        corridor_cuda.corridor_select_cuda(blk.transpose(0, 1), S, sm)
    cor = corridor_cuda.corridor_select_cuda(blk, S, sm)
    args = list(_k1_args(cuda_sc, cor))
    args[5] = args[5].t().contiguous().t()  # x0 not contiguous
    with pytest.raises(ValueError):
        admm_cuda.solve_mpc_qp_fused_cuda(*args)


def _sweep_qps(sc):
    """Per-lane weighted QPs (random weight rows) for the scenario's lanes."""
    cfg, model, fleet = sc["cfg"], sc["model"], sc["fleet"]
    B, dev = fleet.batch, sc["blk"].device
    rng = np.random.default_rng(1)
    Q = torch.tensor(rng.uniform(0.5, 2.0, (B, 3)) * [1.0, 0.1, 0.0],
                     dtype=torch.float32, device=dev)
    R = torch.tensor(rng.uniform(0.01, 0.5, (B, 2)), dtype=torch.float32,
                     device=dev)
    S, sm = cfg.max_segments, model.safety_margin
    cor = corridor_cuda.corridor_select_cuda(sc["blk"], S, sm)
    qp, _ = mpc_pre_solve(fleet, cfg, model, mpc_locate(fleet, sc["path"]),
                          cor, solver_inputs_from_block(sc["blk"], S),
                          WeightSet(Q=Q, R=R, QN=Q.clone()))
    return pack_qp(qp)


@pytest.mark.cuda
def test_k3_kernel_matches_plain(cuda_sc):
    """K3 against its plain version at K1's bars (in practice bitwise)."""
    sq = _sweep_qps(cuda_sc)
    warm, cfg = cuda_sc["fleet"].solver, cuda_sc["cfg"].solver
    raw_k = admm_cuda.solve_ltv_qp_structured_cuda(sq, warm, cfg)
    raw_p = admm_cuda.solve_ltv_qp_structured_plain(sq, warm, cfg)
    torch.cuda.synchronize()
    qmax = sq.qv.abs().flatten(1).amax(1)
    sol_k = admm_cuda.finish_solve(raw_k, qmax, cfg)
    sol_p = admm_cuda.finish_solve(raw_p, qmax, cfg)
    assert (sol_k.status == sol_p.status).float().mean() >= 0.995
    assert float((sol_k.r_prim - sol_p.r_prim).abs().max()) <= 1e-4
    acc = (sol_k.r_prim <= 5e-3) & (sol_p.r_prim <= 5e-3)
    assert float((sol_k.U[:, 0] - sol_p.U[:, 0]).abs()[acc].max()) <= 3e-3


@pytest.mark.cuda
@pytest.mark.parametrize("grids", ["shared", "per_lane"])
def test_k4_kernel_bitwise_equals_plain(cuda_sc, grids):
    grid, path, cfg = cuda_sc["grid"], cuda_sc["path"], cuda_sc["cfg"]
    scan = corridor_extract.build_scanline_table(grid, path,
                                                 cfg.n_scan_samples)
    _, idx = _locate_horizon(cuda_sc["fleet"], path, cfg)
    h = corridor_extract.horizon_tables(scan, idx)
    occ = grid.occ
    if grids == "per_lane":
        occ = occ.expand(idx.shape[0], -1, -1).clone()
        gen = torch.Generator(device=occ.device).manual_seed(0)
        hit = torch.rand(occ.shape, generator=gen, device=occ.device) < 0.01
        occ[hit] = 0.0
    ker = corridor_extract.extract_occ_cuda(occ, h.px, h.py)
    ref = corridor_extract.extract_occ_gather(occ, h.px, h.py)
    torch.cuda.synchronize()
    assert torch.equal(ker, ref)


@pytest.mark.cuda
def test_dynamic_fleet_on_card_equals_static(cuda_sc):
    """On the card, the dynamic-grid fleet (K4, K2, K1) drives exactly as
    the static-grid fleet (K2, K1) on the unchanged grid."""
    kw = dict(grid=cuda_sc["grid"], path=cuda_sc["path"], cfg=cuda_sc["cfg"],
              model=cuda_sc["model"], state0=cuda_sc["fleet"])
    n0 = corridor_extract.extract_occ_cuda.launches
    dyn = simulate_fleet(sim=SimConfig(max_steps=3, static_grid=False), **kw)
    static = simulate_fleet(sim=SimConfig(max_steps=3), table=cuda_sc["table"],
                            **kw)
    assert corridor_extract.extract_occ_cuda.launches == n0 + 3
    for f in static.log._fields:
        assert torch.equal(getattr(dyn.log, f), getattr(static.log, f)), f


def _hits(occ, px, py, nb, seed):
    """(hpx, hpy, hit) for (B, nb) beams: 60 % hits on random cells, and
    a quarter of the beams on the lane's own scanline samples, so that an
    extraction reading the grid before the write-back would differ."""
    Bsz, H, W = occ.shape
    dev = occ.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    hpx = torch.randint(0, W, (Bsz, nb), generator=gen, device=dev,
                        dtype=torch.int32)
    hpy = torch.randint(0, H, (Bsz, nb), generator=gen, device=dev,
                        dtype=torch.int32)
    hit = torch.rand((Bsz, nb), generator=gen, device=dev) < 0.6
    on = nb // 4
    flat = torch.randint(0, px.shape[1] * px.shape[2], (Bsz, on),
                         generator=gen, device=dev)
    hpx[:, :on] = px.flatten(1).gather(1, flat)
    hpy[:, :on] = py.flatten(1).gather(1, flat)
    hit[:, :on] = True
    return hpx, hpy, hit


def _lane_maps(cuda_sc, lanes):
    grid, path, cfg = cuda_sc["grid"], cuda_sc["path"], cuda_sc["cfg"]
    scan = corridor_extract.build_scanline_table(grid, path,
                                                 cfg.n_scan_samples)
    _, idx = _locate_horizon(cuda_sc["fleet"], path, cfg)
    h = corridor_extract.horizon_tables(scan, idx[:lanes])
    occ = grid.occ.expand(lanes, -1, -1).clone()
    gen = torch.Generator(device=occ.device).manual_seed(1)
    occ[torch.rand(occ.shape, generator=gen, device=occ.device) < 0.01] = 0.0
    return occ, h.px.contiguous(), h.py.contiguous()


@pytest.mark.cuda
def test_k5_k6_kernels_bitwise_equal_plain(cuda_sc):
    occ, px, py = _lane_maps(cuda_sc, 64)
    hpx, hpy, hit = _hits(occ, px, py, 91, 2)
    o5, v5 = mapping.writeback_extract_cuda(occ, hpx, hpy, hit, px, py)
    r5, w5 = mapping.writeback_extract_plain(occ, hpx, hpy, hit, px, py)
    pk = mapping.pack_rows(occ)
    o6, v6 = mapping.writeback_extract_packed_cuda(pk, hpx, hpy, hit, px, py)
    r6, w6 = mapping.writeback_extract_packed_plain(pk, hpx, hpy, hit, px, py)
    torch.cuda.synchronize()
    assert torch.equal(o5, r5) and torch.equal(v5, w5)
    assert torch.equal(o6, r6) and torch.equal(v6, w6)
    assert torch.equal(mapping.unpack_rows(o6, occ.shape[1]), o5)
    assert torch.equal(v6, v5)
    assert not torch.equal(v5, corridor_extract.extract_occ_gather(occ, px, py))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_k5_k6_on_a_real_track_sized_grid(cuda_device):
    """767 x 867: rows not a multiple of 32 or of 4 floats (K5's scalar
    copy) and 83,232 bytes of packed words per lane (K6 above 48 KB of
    shared memory)."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(3)
    occ = (torch.rand((16, 767, 867), generator=gen, device=dev) < 0.7).float()
    px = torch.randint(0, 867, (16, 30, 128), generator=gen, device=dev,
                       dtype=torch.int32)
    py = torch.randint(0, 767, (16, 30, 128), generator=gen, device=dev,
                       dtype=torch.int32)
    hpx, hpy, hit = _hits(occ, px, py, 91, 4)
    hpy[:, -1] = 766  # the last row, next to the free padding
    o5, v5 = mapping.writeback_extract_cuda(occ, hpx, hpy, hit, px, py)
    r5, w5 = mapping.writeback_extract_plain(occ, hpx, hpy, hit, px, py)
    o6, v6 = mapping.writeback_extract_packed_cuda(mapping.pack_rows(occ),
                                                   hpx, hpy, hit, px, py)
    torch.cuda.synchronize()
    assert torch.equal(o5, r5) and torch.equal(v5, w5)
    assert torch.equal(mapping.unpack_rows(o6, 767), o5) and torch.equal(v6, v5)
    assert bool((mapping.unpack_rows(o6, 768)[:, 767] == 1.0).all())


@pytest.mark.cuda
def test_lidar_fleet_on_card_equals_dynamic(cuda_sc):
    """On the card the LiDAR fleet with the true map as known map (cells
    scan, packed write-back: K7, K6, K8, K2, K1) drives exactly as the
    dynamic-grid fleet (K4, K8, K2, K1), and its maps stay the true grid."""
    kw = dict(path=cuda_sc["path"], cfg=cuda_sc["cfg"], model=cuda_sc["model"],
              state0=cuda_sc["fleet"])
    n6 = mapping.writeback_extract_packed_cuda.launches
    n7 = lidar.cells_min_cuda.launches
    n8 = kernels.launch_counts()["free_runs"]
    res, occ = simulate_lidar_fleet(
        cuda_sc["grid"], cuda_sc["grid"], sim=SimConfig(max_steps=3),
        lidar=LidarConfig(FoV=360, range=1.0, resolution=4,
                          n_ray_samples=192), **kw)
    assert mapping.writeback_extract_packed_cuda.launches == n6 + 3
    assert lidar.cells_min_cuda.launches == n7 + 3
    assert kernels.launch_counts()["free_runs"] == n8 + 3
    dyn = simulate_fleet(cuda_sc["grid"],
                         sim=SimConfig(max_steps=3, static_grid=False), **kw)
    assert kernels.launch_counts()["free_runs"] == n8 + 6
    for f in dyn.log._fields:
        assert torch.equal(getattr(res.log, f), getattr(dyn.log, f)), f
    assert torch.equal(occ, cuda_sc["grid"].occ.expand_as(occ))


# ---------------------------------------------------------------------------
# K7, the cells scan's sweep: bitwise equal to its plain version
# ---------------------------------------------------------------------------

def _k7_inputs(sc, B, table, seed=0):
    """The sweep's inputs for B poses near random Sim_Track waypoints (up
    to 6 cm off the centre line, any heading), each lane on its waypoint's
    row of the per-waypoint table, or the global table."""
    from multi_purpose_mpc_tpu_torch.simulation import resolve_cell_table

    grid, path = sc["grid"], sc["path"]
    lid = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    if "tables" not in sc:
        glob = lidar.occupied_cell_table(grid.occ)
        sc["tables"] = dict(global_=glob, per_waypoint=resolve_cell_table(
            grid, path, lid, glob, "cells"))
    rng = np.random.default_rng(seed)
    wp = torch.tensor(rng.integers(0, path.n_wp, B), dtype=torch.int32,
                      device=grid.device)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=grid.device)
    x = path.x[wp.long()] + t(rng.uniform(-0.06, 0.06, B))
    y = path.y[wp.long()] + t(rng.uniform(-0.06, 0.06, B))
    psi = t(rng.uniform(-np.pi, np.pi, B))
    _, cx, cy, ux, uy, support = lidar.cells_prologue(grid, x, y, psi, lid)
    cells = sc["tables"]["global_" if table == "global" else table]
    return (grid, cells, wp, cx, cy, ux, uy, support, lid.range)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["global", "per_waypoint"])
@pytest.mark.parametrize("B", [1, 33, 1024])
def test_k7_kernel_bitwise_equals_plain(cuda_sc, B, table):
    args = _k7_inputs(cuda_sc, B, table, seed=B)
    n7 = lidar.cells_min_cuda.launches
    ker = lidar.cells_min(*args)
    ref = lidar.cells_min_plain(*args)
    torch.cuda.synchronize()
    assert lidar.cells_min_cuda.launches == n7 + 1
    for k, r in zip(ker, ref):
        assert k.shape == (B, 91) and _same_bits(k, r)
    if B > 1:
        assert 0.0 < float((ker[0] < 1.0).float().mean()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["global", "per_waypoint"])
def test_k7_kernel_breaks_ties_as_plain(cuda_device, table):
    """scan_ties.tie_world on the card: every pose's middle beam meets two
    cells at one distance; the kernel keeps the smaller id, as the plain
    version does."""
    from scan_ties import tie_world

    w = tie_world(cuda_device)
    args = (w["grid"], w["wpc"] if table == "per_waypoint" else w["cells"],
            w["wp_id"], w["cx"], w["cy"], w["ux"], w["uy"], w["support"], 1.0)
    ker = lidar.cells_min_cuda(*args)
    ref = lidar.cells_min_plain(*args)
    torch.cuda.synchronize()
    for k, r in zip(ker, ref):
        assert _same_bits(k, r)
    W = w["grid"].occ.shape[1]
    res = float(w["grid"].resolution)
    sx = torch.floor((w["x"] - w["grid"].origin[0]) / res)
    sy = torch.floor((w["y"] - w["grid"].origin[1]) / res)
    assert torch.equal(ker[1][:, 45], (sy + 1) * W + sx + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("poses", ["off_track", "on_track"])
def test_k7_cell_table_falls_back_as_plain(cuda_device, poses):
    """cell_table_poses on the card: K7 over the pruned CellTable equals
    the plain sweep bit for bit and the global table's sweep; it sends the
    lanes past the reach (every off-track lane, no on-track one) to the
    global table and counts them once a lane, as the plain sweep does.
    Poses and inputs are made on the CPU and copied."""
    from cell_table_poses import LIDAR, ONE_BEAM, off_track, on_track, sim_track
    from multi_purpose_mpc_tpu_torch.simulation import resolve_cell_table
    from multi_purpose_mpc_tpu_torch.utils import spans
    from multi_purpose_mpc_tpu_torch.utils.tree import tree_map

    grid, path = sim_track()
    table = resolve_cell_table(grid, path, LIDAR, None, "cells")
    if poses == "off_track":
        lid = ONE_BEAM
        x, y, psi, wp = off_track(grid, path, LIDAR.range
                                  + lidar.waypoint_slack(path))
    else:
        lid = LIDAR
        x, y, psi, wp = on_track(grid, path, lanes=1024)
    pro = lidar.cells_prologue(grid, x, y, psi, lid)[1:]
    far = int(table.fallback(pro[0], pro[1], wp).sum())
    assert far == (len(x) if poses == "off_track" else 0)
    on = lambda t: tree_map(lambda v: v.to(cuda_device).contiguous(), t)
    grid, table, wp, pro = on(grid), on(table), on(wp), on(pro)
    args = (grid, table, wp, *pro, lid.range)
    count = lambda: spans.counters().get("cell_table_fallbacks", 0)
    n0 = count()
    ker = lidar.cells_min_cuda(*args)
    torch.cuda.synchronize()
    n1 = count()
    ref = lidar.cells_min_plain(*args)
    every = lidar.cells_min_cuda(grid, table.every, None, *pro, lid.range)
    torch.cuda.synchronize()
    assert n1 - n0 == far and count() - n1 == far
    for k, r, e in zip(ker, ref, every):
        assert _same_bits(k, r) and _same_bits(k, e)


# ---------------------------------------------------------------------------
# K8, the free runs: bitwise equal to its plain route
# ---------------------------------------------------------------------------

def _k8_same(vals, table, idx, min_width, S):
    """K8 through the dispatching wrapper against its plain route on the
    card; returns the kernel's candidates."""
    n8 = corridor_extract.free_runs_cuda.launches
    ker = corridor_extract.horizon_segments_from_table(vals, table, idx,
                                                       min_width, S)
    ref = corridor_extract.horizon_segments(
        vals, corridor_extract.horizon_tables(table, idx), min_width, S)
    torch.cuda.synchronize()
    assert corridor_extract.free_runs_cuda.launches == n8 + 1
    for k, r in zip(ker, ref):
        assert k.dtype == r.dtype and k.shape == r.shape
        assert bool((k.view(torch.uint8) == r.view(torch.uint8)).all())
    return ker


@pytest.fixture(scope="module")
def k8_tables(cuda_sc):
    """Sim_Track's and Real_Track's scanline tables on the card, each with
    its path and safety margin."""
    from multi_purpose_mpc_tpu_torch.config import real_track_preset

    rt_map, rt_path_cfg, rt_model, rt_cfg, _, _ = real_track_preset(ASSETS)
    rt_grid = load_grid_map(rt_map, device=cuda_sc["grid"].device)
    rt_path = build_reference_path(rt_grid, rt_path_cfg)
    K = cuda_sc["cfg"].n_scan_samples
    return {name: (corridor_extract.build_scanline_table(g, p, K), g, p,
                   2.0 * m.safety_margin)
            for name, g, p, m in (
                ("sim_track", cuda_sc["grid"], cuda_sc["path"],
                 cuda_sc["model"]),
                ("real_track", rt_grid, rt_path, rt_model))}


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["sim_track", "real_track"])
@pytest.mark.parametrize("B", [1, 33, 4096])
def test_k8_kernel_bitwise_equals_plain(cuda_sc, k8_tables, B, table):
    """Random horizons on the scanline tables of both tracks: the samples
    of the track's grid, and random 0/1 samples at free shares 0.1, 0.5
    and 0.9 (lanes in turn)."""
    from multi_purpose_mpc_tpu_torch.ops.path import gather_waypoint_index

    scan, grid, path, mw = k8_tables[table]
    dev, N = grid.device, cuda_sc["cfg"].N
    gen = torch.Generator(device=dev).manual_seed(B)
    wp = torch.randint(0, path.n_wp, (B, 1), generator=gen, device=dev)
    idx = gather_waypoint_index(path, wp + 1,
                                torch.arange(N, device=dev)[None])
    occ = corridor_extract.extract_occ(grid.occ, *corridor_extract
                                       .horizon_pixels(scan, idx))
    share = torch.tensor([0.1, 0.5, 0.9], device=dev)[
        torch.arange(B, device=dev) % 3]
    rand = (torch.rand(occ.shape, generator=gen, device=dev)
            < share[:, None, None]).float()
    for vals in (occ, rand):
        out = _k8_same(vals, scan, idx, mw, cuda_sc["cfg"].max_segments)
        assert out.valid.shape == (B, N, cuda_sc["cfg"].max_segments)
        # one lane at free share 0.1 may hold no run as wide as the margin
        assert bool(out.valid.any()) or (vals is rand and B == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [40, 128, 256])
def test_k8_kernel_bitwise_on_scanline_patterns(cuda_device, K):
    """free_runs_cases' patterns: random, all free, all occupied, runs
    touching sample 0 and K - 1, more runs than slots, out-of-bounds
    samples; one warp ballot word short of full at K = 40, eight at
    256."""
    from free_runs_cases import TIE_WIDTH, case

    for B in (1, 33):
        vals, table, idx = case(B, 30, K, seed=K + B, device=cuda_device)
        for mw in (TIE_WIDTH, 0.0):
            kept = _k8_same(vals, table, idx, mw, 8).valid.sum(-1)
            assert int(kept.max()) == 8


@pytest.mark.cuda
@pytest.mark.parametrize("min_width", [5.0 / 128, 0.04])
@pytest.mark.parametrize("S", [8, 32])
def test_k8_kernel_breaks_width_ties_as_plain(cuda_device, min_width, S):
    """Widths planted on min_width: exactly (3/128, 4/128 against 5/128;
    (w, 0)), an ulp either side, and within an ulp or two (polar); the
    kernel's hypotf rounds as torch.hypot does on the card."""
    from free_runs_cases import case, tie_row

    vals, table, idx = case(33, 30, 128, seed=S, ties=True,
                            min_width=min_width, device=cuda_device)
    kept = _k8_same(vals, table, idx, min_width, S).valid
    runs = int((tie_row(128) > 0.5).sum()) // 2
    assert 0 < int(kept.sum()) < min(runs, S) * kept.shape[0] * kept.shape[1]


@pytest.mark.cuda
def test_k8_on_a_lidar_rollout_steps_samples(cuda_sc):
    """The samples of a real LiDAR step: a discovery fleet's scans of the
    true world written into all-free packed maps by K6, as the packed
    step does, then K8 on them."""
    from multi_purpose_mpc_tpu_torch.ops.lidar import hit_pixels, scan_fleet
    from multi_purpose_mpc_tpu_torch.simulation import resolve_cell_table

    sc = cuda_sc
    grid, path, cfg, fleet = sc["grid"], sc["path"], sc["cfg"], sc["fleet"]
    lid = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    scan = corridor_extract.build_scanline_table(grid, path,
                                                 cfg.n_scan_samples)
    cells = resolve_cell_table(grid, path, lid,
                               lidar.occupied_cell_table(grid.occ), "cells")
    _, idx = _locate_horizon(fleet, path, cfg)
    scans = scan_fleet(grid, fleet.x, fleet.y, fleet.psi, lid, cells=cells,
                       backend="cells", wp_id=fleet.wp_id)
    hpx, hpy = hit_pixels(grid, scans, *grid.occ.shape)
    free = mapping.pack_rows(torch.ones_like(grid.occ).expand(
        fleet.batch, -1, -1).contiguous())
    px, py = corridor_extract.horizon_pixels(scan, idx)
    _, vals = mapping.writeback_extract_packed_cuda(
        free, hpx.contiguous(), hpy.contiguous(), scans.hit.contiguous(), px,
        py)
    assert bool((vals < 0.5).any())  # the scans' hits reach the scanlines
    out = _k8_same(vals, scan, idx, 2.0 * sc["model"].safety_margin,
                   cfg.max_segments)
    assert bool((out.valid.sum(-1) >= 2).any())


@pytest.mark.cuda
def test_k8_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    from free_runs_cases import case

    vals, table, idx = case(2, 3, 128, seed=0, device=cuda_device)
    ok = corridor_extract.free_runs_cuda(vals, table, idx, 0.04, 8)
    assert ok.valid.shape == (2, 3, 8)
    bad = [(vals.double(), table, idx, 0.04, 8),
           (vals.transpose(0, 1).contiguous().transpose(0, 1), table, idx,
            0.04, 8),
           (vals, table, idx.int(), 0.04, 8),
           (vals, table, idx.cpu(), 0.04, 8),
           (vals, table._replace(cx=table.cx.double()), idx, 0.04, 8),
           (vals, table._replace(inb=table.inb.float()), idx, 0.04, 8),
           (vals, table, idx, torch.tensor(0.04, device=cuda_device), 8),
           (vals, table, idx, 0.04, 0),
           (*case(1, 2, 257, seed=0, device=cuda_device), 0.04, 8)]
    for args in bad:
        with pytest.raises(ValueError):
            corridor_extract.free_runs_cuda(*args)


# ---------------------------------------------------------------------------
# K1 and K3 at any horizon: one warp per lane, bitwise equal to the plain
# versions.  A reduced budget keeps the plain versions quick; the kernels'
# arithmetic does not depend on it.
# ---------------------------------------------------------------------------

def _same_bits(a, b):
    """Equal bit for bit, NaN equal to NaN: where several terms of a max
    reduction are NaN, the warp's reduction tree may return another NaN
    payload than a left-to-right maximum (csrc/admm_core.cuh)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def _budget(cfg):
    return dataclasses.replace(cfg.solver, iterations=8, rho_updates=2,
                               polish_iters=4)


def _k1_random(N, B, seed, dev):
    """K1 inputs for B lanes at horizon N from numpy draws: horizon data in
    the Sim_Track ranges, corridors of random width (a few collapsed),
    random warm iterates."""
    _, _, model, cfg, _, _ = sim_track_preset(ASSETS)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, (B,) + shape)
    half = u(0.0, 0.08, N) * (u(0, 1, N) > 0.05)
    ctr = u(-0.05, 0.05, N)
    x0 = np.stack([u(-0.06, 0.06), u(-0.2, 0.2), np.zeros(B)], -1)
    warm = init_solver_carry(N, B, cfg.solver.rho, dev)
    warm.X = t(u(-0.05, 0.05, N + 1, 3))
    warm.Zx = t(u(-0.05, 0.05, N + 1, 3))
    warm.Yeq = t(u(-1e-3, 1e-3, N + 1, 3))
    warm.rho = t(u(0.01, 1.0))
    return (t(u(0.4, 1.2, N)), t(u(-4.0, 4.0, N)), t(u(0.03, 0.06, N)),
            t(ctr - half), t(ctr + half), t(x0), t(u(-4.0, 4.0, N)), warm,
            _budget(cfg), cfg, model)


def _k3_random(N, B, seed, dev):
    """K3 inputs: K1's assembled QPs with per-lane cost weights."""
    args = _k1_random(N, B, seed, dev)
    sq, _ = admm_cuda.assemble_stage_qp(*args[:7], args[9], args[10])
    rng = np.random.default_rng(seed + 1)
    scale = torch.tensor(rng.uniform(0.5, 2.0, (B, 1, 5)),
                         dtype=torch.float32, device=dev)
    sq = dataclasses.replace(
        sq, Pd=(sq.Pd * scale).contiguous(),
        **{f: getattr(sq, f).contiguous() for f in ("AB", "beq", "qv", "lw",
                                                    "uw")})
    return sq, args[7], args[8]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 256])
@pytest.mark.parametrize("N", [1, 30, 31, 32, 33, 60])
def test_k1_k3_bitwise_equal_plain_at_any_horizon(cuda_device, N, B):
    """One stage per thread up to N = 31, two from N = 32 (the recurrences
    cross from thread 31's first stage to thread 0's second), a ragged
    last block at B = 33."""
    args = _k1_random(N, B, 10 * N + B, cuda_device)
    ker = admm_cuda.solve_mpc_qp_fused_cuda(*args)
    ref = admm_cuda.solve_mpc_qp_fused_plain(*args)
    sq, warm, solver = _k3_random(N, B, 10 * N + B, cuda_device)
    ker3 = admm_cuda.solve_ltv_qp_structured_cuda(sq, warm, solver)
    ref3 = admm_cuda.solve_ltv_qp_structured_plain(sq, warm, solver)
    torch.cuda.synchronize()
    names = ("W", "Zw", "Yeq", "Yw", "rho", "r_prim", "r_dual", "floor")
    for name, a, b in zip(names, ker, ref):
        assert _same_bits(a, b), f"K1 {name}"
    for name, a, b in zip(names, ker3, ref3):
        assert _same_bits(a, b), f"K3 {name}"
    assert torch.isfinite(ker[0]).all() and torch.isfinite(ker3[0]).all()


@pytest.mark.cuda
def test_k1_k3_nan_lane_stays_in_its_lane(cuda_device):
    """A NaN in lane 0's horizon data makes lane 0 non-finite and leaves the
    other lanes of its block (and every other block) bit for bit as they
    are without it."""
    N, B = 30, 33
    args = list(_k1_random(N, B, 7, cuda_device))
    clean = admm_cuda.solve_mpc_qp_fused_cuda(*args)
    sq, warm, solver = _k3_random(N, B, 7, cuda_device)
    clean3 = admm_cuda.solve_ltv_qp_structured_cuda(sq, warm, solver)
    args[0] = args[0].clone()
    args[0][0, 3] = float("nan")
    dirty = admm_cuda.solve_mpc_qp_fused_cuda(*args)
    sq.qv[0, 5, 0] = float("nan")
    dirty3 = admm_cuda.solve_ltv_qp_structured_cuda(sq, warm, solver)
    torch.cuda.synchronize()
    for a, b in zip(clean + clean3, dirty + dirty3):
        assert _same_bits(a[1:], b[1:])
    assert not torch.isfinite(dirty[0][0]).all()
    assert not torch.isfinite(dirty3[0][0]).all()
    sol, _ = admm_cuda.finish(dirty, args[0], args[1], args[3], args[4],
                              args[8], args[9])
    assert int(sol.status[0]) == 2 and (sol.status[1:] != 2).all()


@pytest.mark.cuda
def test_k1_k3_refuse_horizons_past_n_max(cuda_device):
    N = admm_cuda.N_MAX + 1
    args = _k1_random(N, 2, 0, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        admm_cuda.solve_mpc_qp_fused_cuda(*args)
    sq, warm, solver = _k3_random(N, 2, 0, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        admm_cuda.solve_ltv_qp_structured_cuda(sq, warm, solver)
    # the longest horizon the kernels take still runs
    args = _k1_random(admm_cuda.N_MAX, 2, 0, cuda_device)
    out = admm_cuda.solve_mpc_qp_fused_cuda(*args)
    torch.cuda.synchronize()
    assert out[0].shape == (2, admm_cuda.N_MAX + 1, 5)


# ---------------------------------------------------------------------------
# K1 and K3 with block cyclic reduction as the stage solver
# (SolverConfig(stage_solver="cr")): bitwise equal to the CR plain versions
# ---------------------------------------------------------------------------

def _cr(args):
    """K1 or K3 inputs with the CR stage solver in their SolverConfig."""
    return [dataclasses.replace(a, stage_solver="cr")
            if isinstance(a, SolverConfig) else a for a in args]


CR_CASES = [(N, B) for N in (1, 2, 8, 30, 31, 32, 60, admm_cuda.N_MAX_CR)
            for B in (1, 33, 256)] + [(30, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,B", CR_CASES)
def test_k1_k3_cr_bitwise_equal_plain(cuda_device, N, B):
    """N = 1 and 2 pad to M = 3 (one level), N = 8 pads 9 to 15, N = 30
    fills the 31 padded stages exactly, N = 31 and 32 pad to 63 and N = 60
    pads 61 to 63 (32 even stages on the first level: six rounds of the
    solve's groups), N_MAX_CR pads to 511 (one lane a block).  Every case
    has a NaN lane (lane B // 2) that stays in its lane; at B = 1 the clean
    lane is checked first."""
    args = _cr(_k1_random(N, B, 10 * N + B, cuda_device))
    sq, warm, solver = _cr(_k3_random(N, B, 10 * N + B, cuda_device))
    nan_lane = B // 2
    runs = [False, True] if B == 1 else [True]
    for dirty in runs:
        if dirty:
            args[0] = args[0].clone()
            args[0][nan_lane, N // 2] = float("nan")
            sq.qv[nan_lane, N // 2, 0] = float("nan")
        n1 = admm_cuda.solve_mpc_qp_fused_cuda.launches_cr
        n3 = admm_cuda.solve_ltv_qp_structured_cuda.launches_cr
        ker = admm_cuda.solve_mpc_qp_fused_cuda(*args)
        ref = admm_cuda.solve_mpc_qp_fused_plain(*args)
        ker3 = admm_cuda.solve_ltv_qp_structured_cuda(sq, warm, solver)
        ref3 = admm_cuda.solve_ltv_qp_structured_plain(sq, warm, solver)
        torch.cuda.synchronize()
        assert admm_cuda.solve_mpc_qp_fused_cuda.launches_cr == n1 + 1
        assert admm_cuda.solve_ltv_qp_structured_cuda.launches_cr == n3 + 1
        names = ("W", "Zw", "Yeq", "Yw", "rho", "r_prim", "r_dual", "floor")
        for name, a, b in zip(names, ker, ref):
            assert _same_bits(a, b), f"K1-CR {name}"
        for name, a, b in zip(names, ker3, ref3):
            assert _same_bits(a, b), f"K3-CR {name}"
        clean = torch.ones(B, dtype=torch.bool, device=cuda_device)
        if dirty:
            clean[nan_lane] = False
            assert not torch.isfinite(ker[0][nan_lane]).all()
            assert not torch.isfinite(ker3[0][nan_lane]).all()
        assert torch.isfinite(ker[0][clean]).all()
        assert torch.isfinite(ker3[0][clean]).all()


# the CR kernels' resident lanes per SM at N = 30 (PERF.md section 6): the
# lane's 14,416 bytes of shared memory and 128 registers a thread let 16
# lanes share an SM
CR_LANES_PER_SM_N30 = 16


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "structured"])
def test_cr_resident_lanes_per_sm(cuda_device, kernel):
    lanes, per_sm = admm_cuda.occupancy(kernel, 30, True)
    assert per_sm == CR_LANES_PER_SM_N30, (lanes, per_sm)
    assert lanes * admm_cuda.lane_smem_bytes(30, True) <= 232448
    # Schur keeps its four lanes a block
    assert admm_cuda.occupancy(kernel, 30, False)[0] == 4
    # the longest CR horizon still launches: one lane a block
    assert admm_cuda.occupancy(kernel, admm_cuda.N_MAX_CR, True)[0] >= 1


@pytest.mark.cuda
def test_k1_k3_cr_refuse_horizons_past_n_max_cr(cuda_device):
    N = admm_cuda.N_MAX_CR + 1
    with pytest.raises(ValueError, match="shared memory"):
        admm_cuda.solve_mpc_qp_fused_cuda(*_cr(_k1_random(N, 2, 0, cuda_device)))
    sq, warm, solver = _cr(_k3_random(N, 2, 0, cuda_device))
    with pytest.raises(ValueError, match="shared memory"):
        admm_cuda.solve_ltv_qp_structured_cuda(sq, warm, solver)
    out = admm_cuda.solve_mpc_qp_fused_cuda(
        *_cr(_k1_random(admm_cuda.N_MAX_CR, 2, 0, cuda_device)))
    torch.cuda.synchronize()
    assert out[0].shape == (2, admm_cuda.N_MAX_CR + 1, 5)


# ---------------------------------------------------------------------------
# K2: bitwise equal to the plain version at any horizon, batch and segment
# count, on synthetic blocks with exact ties, zero-width segments, empty
# stages, blocked and NaN lanes (tests/corridor_blocks.py, imported from
# the test directory pytest puts on sys.path: the GPU image may carry a
# ``tests`` package of its own).
# ---------------------------------------------------------------------------

def _k2_check(blk_np, S, dev):
    from corridor_blocks import SM_EXACT

    blk = torch.from_numpy(blk_np).to(dev)
    n0 = corridor_cuda.corridor_select_cuda.launches
    ker = corridor_cuda.corridor_select_cuda(blk, S, SM_EXACT)
    ref = corridor_cuda.corridor_select_plain(blk, S, SM_EXACT)
    torch.cuda.synchronize()
    assert corridor_cuda.corridor_select_cuda.launches == n0 + 1
    for name, a, b in zip(ker._fields, ker, ref):
        assert a.shape == b.shape and a.is_contiguous(), name
        assert _same_bits(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 256])
@pytest.mark.parametrize("N", [1, 30, 60, 513])
def test_k2_bitwise_equal_plain_at_any_horizon(cuda_device, N, B):
    from corridor_blocks import edge_blocks, random_blocks

    _k2_check(random_blocks(B, N, 8, seed=N + B), 8, cuda_device)
    _k2_check(edge_blocks(B, N, 8, seed=N + B), 8, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 8, 13, 40])
def test_k2_bitwise_equal_plain_at_any_segment_count(cuda_device, S):
    """S = 1 (one thread a lane), 13 (16 threads, 3 idle), 40 (32 threads,
    each walking two candidates in index order)."""
    from corridor_blocks import edge_blocks, random_blocks

    for B, N in ((33, 30), (256, 17)):
        _k2_check(random_blocks(B, N, S, seed=S + B), S, cuda_device)
        _k2_check(edge_blocks(B, N, S, seed=S + N), S, cuda_device)


@pytest.mark.cuda
def test_k2_refuses_malformed_blocks(cuda_device):
    from corridor_blocks import random_blocks

    blk = torch.from_numpy(random_blocks(4, 30, 8)).to(cuda_device)
    for bad in (blk.double(), blk[:, :, :-1], blk.transpose(0, 1),
                blk[:, :, :-1].contiguous(), blk[0]):
        with pytest.raises(ValueError):
            corridor_cuda.corridor_select_cuda(bad, 8, 0.5)
    with pytest.raises(ValueError):  # the width of S = 8 read as S = 7
        corridor_cuda.corridor_select_cuda(blk, 7, 0.5)
    empty = corridor_cuda.corridor_select_cuda(blk[:0], 8, 0.5)
    assert empty.ub.shape == (0, 30)


@pytest.mark.cuda
def test_k2_square_root_is_sqrtf_on_every_float(cuda_device):
    """K2's branch-free square root equals sqrtf on all 2^32 inputs (NaN
    equal to NaN): the kernel's bitwise agreement rests on it."""
    assert corridor_cuda.sqrt_mismatches(cuda_device) == 0


def _plain_corridor(grid, path, wp, N, min_width, sm, n_samples, S):
    """update_path_constraints through the plain versions of K4 and K2 on
    the same tensors and cached tables."""
    from multi_purpose_mpc_tpu_torch.ops import constraints as cons
    from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
        horizon_block_from_segments)
    from multi_purpose_mpc_tpu_torch.ops.path import gather_waypoint_index

    scan, table = cons.corridor_tables(grid, path, N, n_samples, S)
    idx = gather_waypoint_index(path, wp.long()[:, None],
                                torch.arange(N, device=wp.device)[None, :])
    h = corridor_extract.horizon_tables(scan, idx)
    segs = corridor_extract.horizon_segments(
        corridor_extract.extract_occ_gather(grid.occ, h.px, h.py), h,
        min_width, S)
    blk = horizon_block_from_segments(
        table, gather_waypoint_index(path, wp.long(), 0), segs)
    return corridor_cuda.corridor_select_plain(blk, S, sm)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 12, 30, 60])
def test_update_path_constraints_on_card_bitwise_equals_plain(cuda_sc, N):
    """The object API's corridor (K4, K8, K2) against the same
    function through the plain versions, bitwise, B = 1, at waypoints
    whose horizon wraps past the end of the circular path."""
    from multi_purpose_mpc_tpu_torch.ops import constraints as cons

    grid, path, cfg = cuda_sc["grid"], cuda_sc["path"], cuda_sc["cfg"]
    sm = cuda_sc["model"].safety_margin
    S = cfg.max_segments
    for wp in (0, 57, path.n_wp - 5, path.n_wp - 1):
        w = torch.tensor([wp], dtype=torch.int32, device=grid.device)
        k4 = corridor_extract.extract_occ_cuda.launches
        k8 = corridor_extract.free_runs_cuda.launches
        k2 = corridor_cuda.corridor_select_cuda.launches
        out = cons.update_path_constraints(grid, path, w, N, 2.0 * sm, sm,
                                           cfg.n_scan_samples, S)
        assert corridor_extract.extract_occ_cuda.launches == k4 + 1
        assert corridor_extract.free_runs_cuda.launches == k8 + 1
        assert corridor_cuda.corridor_select_cuda.launches == k2 + 1
        ref = _plain_corridor(grid, path, w, N, 2.0 * sm, sm,
                              cfg.n_scan_samples, S)
        assert out.ub.shape == (1, N)
        for a, b in zip(out, ref):
            assert torch.equal(a, b), (wp, N)


@pytest.mark.cuda
def test_get_control_launches_k4_k2_k3_once(cuda_device):
    """One step of the object API's two-call loop on the card runs K4, K8,
    K2 and K3 once each and no other kernel."""
    from multi_purpose_mpc_tpu_torch import api

    map_cfg, path_cfg, model, cfg, speed_cfg, obstacles = sim_track_preset(ASSETS)
    m = api.Map(map_cfg.file_path, map_cfg.origin, map_cfg.resolution,
                device=cuda_device)
    rp = api.ReferencePath(m, path_cfg.wp_x, path_cfg.wp_y,
                           path_cfg.resolution, path_cfg.smoothing_distance,
                           path_cfg.max_width, path_cfg.circular)
    m.add_obstacles([api.Obstacle(*o) for o in obstacles])
    car = api.BicycleModel(rp, model.length, model.width, model.Ts)
    kmax = np.tan(cfg.delta_max) / car.length
    ctrl = api.MPC(car, cfg.N, np.diag(cfg.Q), np.diag(cfg.R), np.diag(cfg.QN),
                   {"xmin": np.full(3, -np.inf), "xmax": np.full(3, np.inf)},
                   {"umin": np.array([0.0, -kmax]),
                    "umax": np.array([cfg.v_max, kmax])}, cfg.ay_max)
    rp.compute_speed_profile(speed_cfg)
    counters = ((corridor_extract.extract_occ_cuda, "launches", 1),
                (corridor_extract.free_runs_cuda, "launches", 1),
                (corridor_cuda.corridor_select_cuda, "launches", 1),
                (admm_cuda.solve_ltv_qp_structured_cuda, "launches", 1),
                (admm_cuda.solve_ltv_qp_structured_cuda, "launches_cr", 0),
                (admm_cuda.solve_mpc_qp_fused_cuda, "launches", 0),
                (admm_cuda.solve_mpc_qp_fused_cuda, "launches_cr", 0),
                (mapping.writeback_extract_cuda, "launches", 0),
                (mapping.writeback_extract_packed_cuda, "launches", 0))
    before = [getattr(fn, attr) for fn, attr, _ in counters]
    u = ctrl.get_control()
    for (fn, attr, n), b in zip(counters, before):
        assert getattr(fn, attr) == b + n, (fn.__name__, attr)
    assert u.shape == (2,) and np.isfinite(u).all() and u[0] > 0
    car.drive(u)
    assert car.s > 0.0 and ctrl.infeasibility_counter == 0


# ---------------------------------------------------------------------------
# The scale-out path on the card: NCCL at world size 1 (NCCL needs a GPU
# per rank, and the box has one), and gloo all-reducing CUDA masks between
# two ranks that share the card (tests/torch_dist_worker.py).
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_sharded_fleet_on_nccl_world_one_equals_fleet(cuda_sc):
    import torch.distributed as dist
    from torch_dist_worker import free_port

    from multi_purpose_mpc_tpu_torch.parallel import mesh as pm
    from multi_purpose_mpc_tpu_torch.parallel.fleet import (
        gather_fleet, simulate_fleet_sharded)

    sc, sim = cuda_sc, SimConfig(max_steps=3)
    ref = simulate_fleet(sc["grid"], sc["path"], sc["cfg"], sc["model"], sim,
                         sc["fleet"], table=sc["table"])
    assert pm.init_distributed(f"localhost:{free_port()}", 1, 0,
                               device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        mesh = pm.global_fleet_mesh()
        assert (mesh.rank, mesh.world_size) == (0, 1) and mesh.device.type == "cuda"
        got = gather_fleet(simulate_fleet_sharded(
            mesh, sc["grid"], sc["path"], sc["cfg"], sc["model"], sim,
            sc["fleet"]), mesh)
        m = pm.fleet_metrics(got.log, sc["path"].length, mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for name, a, b in zip(ref.log._fields, got.log, ref.log):
        assert torch.equal(a, b), name
    m_ref = pm.fleet_metrics(ref.log, sc["path"].length)
    for k in m_ref:
        assert torch.equal(m[k], m_ref[k]), k


@pytest.mark.cuda
def test_gloo_pools_cuda_masks_of_two_ranks_as_one_or(cuda_sc, tmp_path):
    from torch_dist_worker import launch

    from multi_purpose_mpc_tpu_torch.ops.grid import make_grid_map
    from multi_purpose_mpc_tpu_torch.ops.lidar import (
        apply_observation_masks, fleet_observation_masks, scan_fleet)

    sc = cuda_sc
    grid, fleet = sc["grid"], sc["fleet"]
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    known = make_grid_map(torch.ones_like(grid.occ), grid.origin,
                          grid.resolution, device=grid.device)
    n = 16
    x, y, psi = fleet.x[:n], fleet.y[:n], fleet.psi[:n]
    scans = scan_fleet(grid, x, y, psi, lidar, backend="march")
    h, w = known.occ.shape
    hm, fm = fleet_observation_masks(known, h, w, x, y, psi, scans, lidar,
                                     clear_free=True, shared=True)
    ref = apply_observation_masks(known.occ, hm, fm)
    spec = dict(device="cuda", grid=grid, path=sc["path"], cfg=sc["cfg"],
                model=sc["model"], lidar=lidar, known=known,
                tasks=dict(pool=dict(kind="pool", x=x, y=y, psi=psi,
                                     scans=scans, clear_free=True)))
    ranks = launch(spec, 2, str(tmp_path), timeout=300)
    assert bool((ref < 0.5).any())
    for r in ranks:
        got = r["pool"]
        assert torch.equal(got["hitmask"], hm.cpu())
        assert torch.equal(got["freemask"], fm.cpu())
        assert torch.equal(got["occ"], ref.cpu())


# ---------------------------------------------------------------------------
# CUDA graphs: every rollout and the object API's control step replay a
# captured graph on the card; the eager form (graphs.disable_capture) is
# what they are held against, bit for bit, launch for launch.
# ---------------------------------------------------------------------------

def _graph_and_eager(run):
    """``run()`` captured and replayed, then in its eager form; each with
    the kernels' launch counts it added."""
    out = []
    for form in ("graph", "eager"):
        before = kernels.launch_counts()
        with (contextlib.nullcontext() if form == "graph"
              else graphs.disable_capture()):
            res = run()
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        out.append((res, {k: after[k] - before[k] for k in after}))
    return out


def _assert_same_tree(a, b):
    from multi_purpose_mpc_tpu_torch.utils.tree import leaves

    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert (_same_bits(x, y) if x.dtype == torch.float32
                else torch.equal(x, y)), i


@pytest.mark.cuda
@pytest.mark.parametrize("grid_kind", ["static", "dynamic"])
def test_fleet_graph_equals_eager(cuda_sc, grid_kind):
    """B = 256 x 5 steps: logs and final state bitwise, the same launches
    (K2 + K1, and K4 on the dynamic grid, once a step)."""
    sc, T = cuda_sc, 5
    sim = SimConfig(max_steps=T, static_grid=grid_kind == "static")
    table = sc["table"] if grid_kind == "static" else None
    (g, ng), (e, ne) = _graph_and_eager(lambda: simulate_fleet(
        sc["grid"], sc["path"], sc["cfg"], sc["model"], sim, sc["fleet"],
        table=table))
    _assert_same_tree(g, e)
    assert ng == ne
    assert ng["admm_fused"] == ng["corridor_select"] == T
    assert ng["extract_occ"] == (0 if grid_kind == "static" else T)
    assert bool(g.log.ok.float().mean() > 0.9)


@pytest.mark.cuda
@pytest.mark.parametrize("grid_kind", ["static", "dynamic"])
def test_fleet_cache_hit_with_fresh_inputs_equals_eager(cuda_sc, grid_kind):
    """B = 256 x 5 steps, twice: the second call, on another fleet, speed
    profile and grid (one more obstacle) of the same shapes, replays the
    first call's cached graphs and captures none; its logs and final
    state bitwise equal to the eager form on its own inputs, the same
    launches, and the first call's result untouched by it."""
    from multi_purpose_mpc_tpu_torch.config import SpeedProfileConstraints
    from multi_purpose_mpc_tpu_torch.utils.profiling import capture_seconds
    from multi_purpose_mpc_tpu_torch.utils.tree import tree_map

    sc, T = cuda_sc, 5
    static = grid_kind == "static"
    sim = SimConfig(max_steps=T, static_grid=static)
    map_cfg = sim_track_preset(ASSETS)[0]
    path = sc["path"]
    grid2 = add_obstacles_host(sc["grid"], map_cfg.origin, map_cfg.resolution,
                               [(float(path.x[60]), float(path.y[60]), 0.02)])
    path2 = compute_speed_profile(path, SpeedProfileConstraints(v_max=0.8))
    rng = np.random.default_rng(1)
    B, dev = sc["fleet"].batch, sc["grid"].device
    fleet2 = init_fleet(
        path2, sc["cfg"].N, B,
        e_y0=torch.tensor(rng.uniform(-0.06, 0.06, B), dtype=torch.float32,
                          device=dev),
        wp_id0=torch.tensor(rng.integers(0, path.n_wp, B), dtype=torch.int32,
                            device=dev))
    run = lambda g, p, f: simulate_fleet(
        g, p, sc["cfg"], sc["model"], sim, f,
        table=static_horizon_table(g, p, sc["cfg"], sc["model"])
        if static else None)
    graphs.clear_cache()
    with capture_seconds() as caps1:
        first = run(sc["grid"], path, sc["fleet"])
    kept = tree_map(torch.clone, first)
    with capture_seconds() as caps2:
        (second, n2), (want, ne) = _graph_and_eager(
            lambda: run(grid2, path2, fleet2))
    assert len(caps1) == 2 and len(caps2) == 0
    _assert_same_tree(second, want)
    _assert_same_tree(first, kept)
    assert n2 == ne and n2["corridor_select"] == T
    assert not torch.equal(first.log.x, second.log.x)


@pytest.mark.cuda
def test_packed_lidar_fleet_graph_equals_eager(cuda_sc):
    """The discovery fleet (cells scan, K6 ping-ponging two map buffers):
    logs, final state and maps bitwise, K7 = K6 = K2 = K1 once a step."""
    sc, T = cuda_sc, 4
    free = dataclasses.replace(sc["grid"], occ=torch.ones_like(sc["grid"].occ))
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    (g, ng), (e, ne) = _graph_and_eager(lambda: simulate_lidar_fleet(
        sc["grid"], free, sc["path"], sc["cfg"], sc["model"],
        SimConfig(max_steps=T, static_grid=False), lidar, sc["fleet"]))
    _assert_same_tree(g, e)
    assert ng == ne
    assert ng["writeback_extract_packed"] == ng["corridor_select"] == T
    assert ng["scan_cells"] == ng["free_runs"] == T
    assert bool((g[1] < 0.5).sum() > 0)  # the scans found cells


def _api_world(device):
    """The object API on the Sim_Track preset: map, path, car and
    controller, as the reference's simulation.py builds them."""
    from multi_purpose_mpc_tpu_torch import api

    map_cfg, path_cfg, model, cfg, speed_cfg, obstacles = sim_track_preset(ASSETS)
    m = api.Map(map_cfg.file_path, map_cfg.origin, map_cfg.resolution,
                device=device)
    rp = api.ReferencePath(m, path_cfg.wp_x, path_cfg.wp_y,
                           path_cfg.resolution, path_cfg.smoothing_distance,
                           path_cfg.max_width, path_cfg.circular)
    m.add_obstacles([api.Obstacle(*o) for o in obstacles])
    car = api.BicycleModel(rp, model.length, model.width, model.Ts)
    kmax = np.tan(cfg.delta_max) / car.length
    ctrl = api.MPC(car, cfg.N, np.diag(cfg.Q), np.diag(cfg.R),
                   np.diag(cfg.QN),
                   {"xmin": np.full(3, -np.inf), "xmax": np.full(3, np.inf)},
                   {"umin": np.array([0.0, -kmax]),
                    "umax": np.array([cfg.v_max, kmax])}, cfg.ay_max)
    rp.compute_speed_profile(speed_cfg)
    return m, rp, car, ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("lidar", [False, True])
def test_get_control_graph_equals_eager(cuda_device, lidar):
    """20 steps of the API lap (with ``LidarModel.scan`` + ``update_map``
    before each control), graphed beside eager on their own cars: the same
    controls and measurements bit for bit and K4 = K8 = K2 = K3 = 1
    launch a step on both."""
    from multi_purpose_mpc_tpu_torch import api

    def loop():
        m, rp, car, ctrl = _api_world(cuda_device)
        sensor = api.LidarModel(FoV=180, range=2.0, resolution=2)
        us = []
        for _ in range(20):
            meas = sensor.scan(car, m).ravel() if lidar else np.zeros(0)
            if lidar:
                sensor.update_map(car, m)
            us.append(np.concatenate([ctrl.get_control(), meas]))
            car.drive(us[-1][:2])
        return np.stack(us), car.state, m.grid.occ

    (g, ng), (e, ne) = _graph_and_eager(loop)
    assert np.array_equal(g[0], e[0]) and g[0][:, 0].min() > 0
    _assert_same_tree(g[1:], e[1:])
    assert ng == ne
    assert ng["extract_occ"] == ng["free_runs"] == ng["corridor_select"] \
        == ng["admm_structured"] == 20


@pytest.mark.cuda
def test_get_control_follows_a_new_speed_profile(cuda_device):
    """Five steps of the API lap, then ``compute_speed_profile`` with
    other limits (it replaces the path, whose corridor tables the first
    graph read), then five more: every control and prediction bitwise
    equal to the eager loop's, K4 = K8 = K2 = K3 = 1 launch a step."""

    def loop():
        m, rp, car, ctrl = _api_world(cuda_device)
        out = []
        for k in range(10):
            if k == 5:
                rp.compute_speed_profile({"a_min": -0.1, "a_max": 0.5,
                                          "v_min": 0.0, "v_max": 0.6,
                                          "ay_max": 4.0})
            u = ctrl.get_control()
            out.append(np.concatenate([u, *ctrl.current_prediction]))
            car.drive(u)
        return np.stack(out), car.state

    (g, ng), (e, ne) = _graph_and_eager(loop)
    assert np.array_equal(g[0], e[0]) and g[0][:, 0].min() > 0
    _assert_same_tree(g[1], e[1])
    assert ng == ne
    assert ng["extract_occ"] == ng["free_runs"] == ng["corridor_select"] \
        == ng["admm_structured"] == 10


@pytest.mark.cuda
def test_capture_of_a_syncing_step_raises(cuda_device):
    """A step that reads a value back to the host cannot be captured: the
    warm-up raises (sync debug mode), and no eager run takes its place."""
    from multi_purpose_mpc_tpu_torch import simulation as tsim

    carry = (torch.zeros(4, device=cuda_device),)
    step = lambda c, _, __: ((c[0] + float(c[0].sum().item()),), (c[0],))
    with pytest.raises(RuntimeError):
        tsim._rollout(step, carry, 3)
    with graphs.disable_capture():
        final, log = tsim._rollout(step, carry, 3)
    assert log[0].shape == (3, 4)


# ---------------------------------------------------------------------------
# The stage clock (utils/spans.py, csrc/stage_clock.cu) inside the graphs.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_captured_rollout_rows_advance_one_a_replay(cuda_sc):
    """A cached rollout's ring holds its last call's steps: the first call
    (warm-up + 5 replays) and a repeated one (6 replays) record 12 steps,
    the ring's 6 rows are the second call's, and the device's stamps rise
    through each step and from one step to the next."""
    from multi_purpose_mpc_tpu_torch.utils import spans

    sc, T = cuda_sc, 6
    graphs.clear_cache()
    for _ in range(2):
        simulate_fleet(sc["grid"], sc["path"], sc["cfg"], sc["model"],
                       SimConfig(max_steps=T), sc["fleet"], table=sc["table"])
        rid = spans.request("rollout")
    torch.cuda.synchronize()
    ring = spans.ring("rollout")
    t = ring.table()
    assert ring.issued == 2 * T and int(ring.count) == 2 * T
    assert t.names == ["locate", "select", "solve", "post"]
    assert t.rid.tolist() == [rid] * T
    assert (np.diff(t.ts, axis=1) > 0).all()
    assert (t.ts[1:, 0] > t.ts[:-1, -1]).all()
    graphs.clear_cache()


@pytest.mark.cuda
def test_api_ring_keeps_rows_across_replays(cuda_device):
    """Five cycles of the object API's graphed loop: a control row and a
    drive row a cycle under its id, in order on the device's clock."""
    from multi_purpose_mpc_tpu_torch.utils import spans

    m, rp, car, ctrl = _api_world(cuda_device)
    first = spans.request("cycle") + 1
    for _ in range(5):
        car.drive(ctrl.get_control())
    torch.cuda.synchronize()
    ctl, drv = spans.ring("control").table(), spans.ring("drive").table()
    ids = list(range(first, first + 5))
    assert ctl.rid[-5:].tolist() == drv.rid[-5:].tolist() == ids
    assert ctl.names == ["corridor", "pre_solve", "solve", "post"]
    c, d = ctl.ts[-5:], drv.ts[-5:]
    assert (np.diff(c, axis=1) > 0).all() and (np.diff(d, axis=1) > 0).all()
    assert (c[:, -1] < d[:, 0]).all() and (d[:-1, -1] < c[1:, 0]).all()


@pytest.mark.cuda
def test_calibration_error_is_bounded(cuda_device, monkeypatch):
    """%globaltimer against perf_counter_ns, read afresh (the clocks drift
    apart by a few ppm): the tightest bracket is under a millisecond, and
    a mark placed on the host clock falls inside the host stamps around
    it, give or take the error."""
    from multi_purpose_mpc_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "_calibrations", {})
    cal = spans.calibration(cuda_device)
    assert 0 <= cal.error_ns < 1_000_000
    ring = spans.StageRing("calibration test", 1, cuda_device)
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    ring.end()
    torch.cuda.synchronize()
    t1 = time.perf_counter_ns()
    at = int(ring.table().ts[0, -1]) + cal.offset_ns
    assert t0 - 2 * cal.error_ns <= at <= t1 + 2 * cal.error_ns
