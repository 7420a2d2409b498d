"""The plain reference at a small size on the CPU, held to the port's
own pieces where both state the same semantics: the world (map, path,
borders, speed profile), the corridor, the fixed-budget ADMM in float64,
the LiDAR scan, and the interior-point QP solver's optimality."""

import os

import numpy as np
import pytest
import torch

from benchmark import checks, run, scenario
from benchmark.reference import admm as A
from benchmark.reference import follow as F
from benchmark.reference import qp as Q
from benchmark.reference import shared as S
from benchmark.reference import world as W

F64 = torch.float64


@pytest.fixture(scope="module", params=["sim_track", "real_track"])
def pair(request):
    cfg = run.load_json(os.path.join(run.HERE, "configs",
                                     f"{request.param}.json"))
    sc = scenario.configs(cfg, run.ROOT)
    grid, path = scenario.world(sc, "cpu")
    return cfg, sc, grid, path, W.build_world(cfg, run.ROOT, "cpu")


def test_world_matches_the_port(pair):
    cfg, sc, grid, path, w = pair
    gap = lambda a, b: float((a.double() - b).abs().max())
    assert torch.equal(grid.occ.double(), w.occ)
    assert w.n_wp == path.n_wp
    assert gap(path.border_ub, w.border_ub) == 0.0
    assert gap(path.border_lb, w.border_lb) == 0.0
    assert gap(path.x, w.x) < 1e-6 and gap(path.kappa, w.kappa) < 1e-5
    # the port's speed profile is a fixed-budget float32 solve
    assert gap(path.v_ref, w.v_ref) < 1e-4


def test_corridor_matches_the_port(pair):
    from multi_purpose_mpc_tpu_torch.mpc import mpc_corridor
    from multi_purpose_mpc_tpu_torch.ops.constraints import extract_all_segments

    cfg, sc, grid, path, w = pair
    wp = torch.arange(0, path.n_wp, 7)
    N = cfg["mpc"]["N"]
    segs = extract_all_segments(grid, path, 2 * sc.model.safety_margin,
                                n_samples=128, max_segments=8)
    port = mpc_corridor(wp.to(torch.int32), path, sc.mpc, sc.model, segs)
    f = checks.Follower(w, cfg, wp)
    cor = W.horizon_index(w, wp, torch.arange(N) + 1)
    ub, lb = F.select(w, cor, *(t[cor] for t in f.static_segments()), f.sm)
    assert float((port.ub.double() - ub).abs().max()) < 1e-5
    assert float((port.lb.double() - lb).abs().max()) < 1e-5


def test_budget_admm_is_the_ports_in_float64():
    from multi_purpose_mpc_tpu_torch.config import MPCConfig, ModelConfig
    from multi_purpose_mpc_tpu_torch.ops import admm_cuda
    from multi_purpose_mpc_tpu_torch.ops.ltv_qp import (SolverCarry,
                                                        init_solver_carry)

    cfg = run.load_json(os.path.join(run.HERE, "configs", "sim_track.json"))
    mpc = cfg["mpc"]
    model = ModelConfig(**cfg["model"])
    N, B = 6, 3
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, dtype=F64)
    v, k, ds = 0.5 + r(B, N), 2 * r(B, N) - 1, 0.05 + 0.01 * r(B, N)
    lb, ub = -0.05 - 0.1 * r(B, N), 0.05 + 0.1 * r(B, N)
    e_y, e_psi, kp = 0.02 * r(B) - 0.01, 0.02 * r(B) - 0.01, r(B, N) - 0.5
    port_cfg = MPCConfig(N=N)
    warm = init_solver_carry(N, B, device="cpu")
    warm = SolverCarry(**{f: getattr(warm, f).double()
                          for f in warm.__dataclass_fields__})
    x0 = torch.stack([e_y, e_psi, torch.zeros(B, dtype=F64)], -1)
    raw = admm_cuda.solve_mpc_qp_fused_plain(v, k, ds, lb, ub, x0, kp, warm,
                                             port_cfg.solver, port_cfg, model)
    kmax = float(np.tan(mpc["delta_max"]) / model.length)
    qp = A.horizon_qp(mpc, kmax, e_y, e_psi, v, k, ds, lb, ub, kp)
    c, rp, _ = A.solve(qp, A.fresh(B, N, 0.1, "cpu"), mpc["solver"])
    U = c.z[:, 3 * (N + 1):].reshape(B, N, 2)
    assert float((U - raw[0][:, :-1, 3:]).abs().max()) < 1e-6
    assert float((rp - raw[5]).abs().max()) < 1e-9
    fl = F.floor(e_y, e_psi, k, ds, lb, ub, kmax)
    assert float((fl - raw[7]).abs().max()) < 1e-12


def test_interior_point_meets_kkt():
    rng = np.random.default_rng(4)
    n, m = 12, 4
    Pd = rng.uniform(0.1, 2.0, n)
    q = rng.normal(size=n)
    Aeq = rng.normal(size=(m, n))
    lo, hi = -rng.uniform(0.1, 1, n), rng.uniform(0.1, 1, n)
    zf = rng.uniform(lo, hi)
    beq = Aeq @ zf
    t = lambda a: torch.as_tensor(a, dtype=F64)[None]
    z, ok = Q.solve(t(np.diag(Pd)), t(q), t(Aeq), t(beq), t(lo), t(hi))
    z = z[0].numpy()
    assert bool(ok[0])
    assert np.abs(Aeq @ z - beq).max() < 1e-8
    assert (z >= lo - 1e-9).all() and (z <= hi + 1e-9).all()
    # stationarity: the gradient lies in the row space plus the active bounds
    grad = Pd * z + q
    free = (z > lo + 1e-6) & (z < hi - 1e-6)
    y, *_ = np.linalg.lstsq(Aeq[:, free].T, -grad[free], rcond=None)
    assert np.abs(grad[free] + Aeq[:, free].T @ y).max() < 1e-6


def test_scan_matches_the_ports_cells_scan():
    from multi_purpose_mpc_tpu_torch.ops import lidar

    cfg = run.load_json(os.path.join(run.HERE, "configs", "sim_track.json"))
    sc = scenario.configs(cfg, run.ROOT)
    grid, path = scenario.world(sc, "cpu")
    w = W.build_world(cfg, run.ROOT, "cpu")
    wp = torch.arange(0, path.n_wp, 25)
    x, y, psi = path.x[wp], path.y[wp] + 0.01, path.psi[wp] + 0.2
    cells = lidar.occupied_cell_table(grid.occ)
    scans = lidar.scan_fleet(grid, x, y, psi, sc.lidar, cells=cells,
                             backend="cells")
    hpx, hpy = lidar.hit_pixels(grid, scans, *grid.occ.shape)
    port = torch.where(scans.hit, hpy.long() * grid.occ.shape[1] + hpx.long(),
                       torch.full_like(hpx.long(), -1))
    ref, d = F.scan(w, F.boundary_cells(w.occ), cfg["lidar"], x, y, psi)
    assert torch.equal(port, ref)
    assert torch.equal(scans.ranges, d)


def test_shared_map_observations_match_the_ports():
    """The reference's free-space pixels, pooled masks and map update
    against ``ops/lidar``'s on the same poses, each from its own scan."""
    from multi_purpose_mpc_tpu_torch.ops import lidar

    cfg = run.load_json(os.path.join(run.HERE, "configs", "sim_track.json"))
    sc = scenario.configs(cfg, run.ROOT)
    grid, path = scenario.world(sc, "cpu")
    w = W.build_world(cfg, run.ROOT, "cpu")
    wp = torch.arange(0, path.n_wp, 5)
    off = torch.linspace(-0.03, 0.03, wp.shape[0])
    x = path.x[wp] - off * torch.sin(path.psi[wp])
    y = path.y[wp] + off * torch.cos(path.psi[wp])
    psi = path.psi[wp] + off
    scans = lidar.scan_fleet(grid, x, y, psi, sc.lidar,
                             cells=lidar.occupied_cell_table(grid.occ),
                             backend="cells")
    fpx, fpy = lidar.free_space_pixels(grid, x, y, psi, scans)
    _, d = F.scan(w, F.boundary_cells(w.occ), cfg["lidar"], x, y, psi)
    rpx, rpy = S.free_pixels(w, cfg["lidar"], x, y, psi, d)
    assert torch.equal(fpx.long(), rpx) and torch.equal(fpy.long(), rpy)
    H, Wd = grid.occ.shape
    hit, free = lidar.fleet_observation_masks(grid, H, Wd, x, y, psi, scans,
                                              sc.lidar, clear_free=True,
                                              shared=True)
    rhit, rfree = S.pooled_masks(w, F.boundary_cells(w.occ), cfg["lidar"],
                                 x, y, psi, chunk=16)
    assert torch.equal(hit, rhit) and torch.equal(free, rfree)
    assert bool(rhit.any()) and bool(rfree.any())
    occ = torch.ones_like(grid.occ)
    occ[::7, ::11] = 0.0
    assert torch.equal(lidar.apply_observation_masks(occ, hit, free).double(),
                       S.update(occ.double(), rhit, rfree))
