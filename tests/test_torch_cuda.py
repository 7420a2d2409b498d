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

import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu_torch.config import (LidarConfig, SimConfig,
                                                SolverConfig,
                                                sim_track_preset)
from multi_purpose_mpc_tpu_torch.mpc import (WeightSet, kappa_predictions,
                                             mpc_locate, mpc_pre_solve)
from multi_purpose_mpc_tpu_torch.ops import (admm_cuda, corridor_cuda,
                                             corridor_extract, mapping)
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
    scan, packed write-back: K6, K2, K1) drives exactly as the dynamic-grid
    fleet (K4, K2, K1), and its maps stay the true grid."""
    kw = dict(path=cuda_sc["path"], cfg=cuda_sc["cfg"], model=cuda_sc["model"],
              state0=cuda_sc["fleet"])
    n6 = mapping.writeback_extract_packed_cuda.launches
    res, occ = simulate_lidar_fleet(
        cuda_sc["grid"], cuda_sc["grid"], sim=SimConfig(max_steps=3),
        lidar=LidarConfig(FoV=360, range=1.0, resolution=4,
                          n_ray_samples=192), **kw)
    dyn = simulate_fleet(cuda_sc["grid"],
                         sim=SimConfig(max_steps=3, static_grid=False), **kw)
    assert mapping.writeback_extract_packed_cuda.launches == n6 + 3
    for f in dyn.log._fields:
        assert torch.equal(getattr(res.log, f), getattr(dyn.log, f)), f
    assert torch.equal(occ, cuda_sc["grid"].occ.expand_as(occ))


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


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 256])
@pytest.mark.parametrize("N", [1, 8, 30, 31, 60])
def test_k1_k3_cr_bitwise_equal_plain(cuda_device, N, B):
    """N = 30 fills the 31 padded stages exactly, N = 8 pads 9 to 15,
    N = 31 pads 32 to 63 and N = 60 pads 61 to 63 (32 even stages on the
    first level).  Lane 0 carries a NaN from B = 33 on: it stays in its lane."""
    args = _cr(_k1_random(N, B, 10 * N + B, cuda_device))
    sq, warm, solver = _cr(_k3_random(N, B, 10 * N + B, cuda_device))
    if B > 1:
        args[0] = args[0].clone()
        args[0][0, N // 2] = float("nan")
        sq.qv[0, N // 2, 0] = float("nan")
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
    clean = slice(1, None) if B > 1 else slice(None)
    assert torch.isfinite(ker[0][clean]).all()
    assert torch.isfinite(ker3[0][clean]).all()
    if B > 1:
        assert not torch.isfinite(ker[0][0]).all()
        assert not torch.isfinite(ker3[0][0]).all()


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
    """The object API's corridor (K4, the free runs, K2) against the same
    function through the plain versions, bitwise, B = 1, at waypoints
    whose horizon wraps past the end of the circular path."""
    from multi_purpose_mpc_tpu_torch.ops import constraints as cons

    grid, path, cfg = cuda_sc["grid"], cuda_sc["path"], cuda_sc["cfg"]
    sm = cuda_sc["model"].safety_margin
    S = cfg.max_segments
    for wp in (0, 57, path.n_wp - 5, path.n_wp - 1):
        w = torch.tensor([wp], dtype=torch.int32, device=grid.device)
        k4 = corridor_extract.extract_occ_cuda.launches
        k2 = corridor_cuda.corridor_select_cuda.launches
        out = cons.update_path_constraints(grid, path, w, N, 2.0 * sm, sm,
                                           cfg.n_scan_samples, S)
        assert corridor_extract.extract_occ_cuda.launches == k4 + 1
        assert corridor_cuda.corridor_select_cuda.launches == k2 + 1
        ref = _plain_corridor(grid, path, w, N, 2.0 * sm, sm,
                              cfg.n_scan_samples, S)
        assert out.ub.shape == (1, N)
        for a, b in zip(out, ref):
            assert torch.equal(a, b), (wp, N)


@pytest.mark.cuda
def test_get_control_launches_k4_k2_k3_once(cuda_device):
    """One step of the object API's two-call loop on the card runs K4, K2
    and K3 once each and no other kernel."""
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
def test_packed_lidar_fleet_graph_equals_eager(cuda_sc):
    """The discovery fleet (cells scan, K6 ping-ponging two map buffers):
    logs, final state and maps bitwise, K6 = K2 = K1 once a step."""
    sc, T = cuda_sc, 4
    free = dataclasses.replace(sc["grid"], occ=torch.ones_like(sc["grid"].occ))
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    (g, ng), (e, ne) = _graph_and_eager(lambda: simulate_lidar_fleet(
        sc["grid"], free, sc["path"], sc["cfg"], sc["model"],
        SimConfig(max_steps=T, static_grid=False), lidar, sc["fleet"]))
    _assert_same_tree(g, e)
    assert ng == ne
    assert ng["writeback_extract_packed"] == ng["corridor_select"] == T
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
    controls and measurements bit for bit and K4 = K2 = K3 = 1 launch a
    step on both."""
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
    assert ng["extract_occ"] == ng["corridor_select"] == \
        ng["admm_structured"] == 20


@pytest.mark.cuda
def test_get_control_follows_a_new_speed_profile(cuda_device):
    """Five steps of the API lap, then ``compute_speed_profile`` with
    other limits (it replaces the path, whose corridor tables the first
    graph read), then five more: every control and prediction bitwise
    equal to the eager loop's, K4 = K2 = K3 = 1 launch a step."""

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
    assert ng["extract_occ"] == ng["corridor_select"] == \
        ng["admm_structured"] == 10


@pytest.mark.cuda
def test_capture_of_a_syncing_step_raises(cuda_device):
    """A step that reads a value back to the host cannot be captured: the
    warm-up raises (sync debug mode), and no eager run takes its place."""
    from multi_purpose_mpc_tpu_torch import simulation as tsim

    carry = (torch.zeros(4, device=cuda_device),)
    step = lambda c, _: ((c[0] + float(c[0].sum().item()),), (c[0],))
    with pytest.raises(RuntimeError):
        tsim._rollout(step, carry, 3)
    with graphs.disable_capture():
        final, log = tsim._rollout(step, carry, 3)
    assert log[0].shape == (3, 4)
