"""The port's CUDA kernels against their plain twins, on the GPU.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tests marked ``cuda`` need an NVIDIA GPU and nvcc; they skip elsewhere
(the decision is made inside the fixture, never at import).  The rest pin
the CPU-side contract of the wrappers and the build.
"""

import os

import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu_torch.config import sim_track_preset
from multi_purpose_mpc_tpu_torch.mpc import kappa_predictions, mpc_locate
from multi_purpose_mpc_tpu_torch.ops import admm_cuda, corridor_cuda
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
    gather_horizon_block, solver_inputs_from_block)
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import init_solver_carry
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.simulation import (init_fleet,
                                                    static_horizon_table)
from multi_purpose_mpc_tpu_torch.utils import kernels
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
    return dict(path=path, table=table, fleet=fleet, blk=blk, e_y=e_y,
                e_psi=e_psi, model=model, cfg=cfg)


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


def test_library_path_is_keyed_by_source():
    p = kernels.library_path("admm_fused")
    assert p.parent.parent == kernels.BUILD_DIR and p.name == "libadmm_fused.so"
    assert len(p.parent.name) == 16
    assert kernels.library_path("admm_fused") == p
    assert kernels.library_path("corridor_select").parent != p.parent


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
            z, z, z, z, z, torch.zeros((2, 3)), z, init_solver_carry(30, 2),
            sim_track_preset()[3].solver, sim_track_preset()[3],
            sim_track_preset()[2])


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
