"""The frozen counts of ``benchmark/counts`` tied, at small sizes on the
CPU, to the plain twins they were frozen from: ``chip_smoke``'s operation
count (one operation per output element of each elementwise aten op, per
input element of each reduction) and byte count (each distinct input and
output tensor once)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from benchmark.counts import k1, k3, k6, k7
from multi_purpose_mpc_tpu_torch.config import (MPCConfig, ModelConfig,
                                                SolverConfig)
from multi_purpose_mpc_tpu_torch.mpc import assemble_ltv_qp
from multi_purpose_mpc_tpu_torch.ops import admm_cuda, mapping
from multi_purpose_mpc_tpu_torch.ops.constraints import Corridor
from multi_purpose_mpc_tpu_torch.ops.grid import make_grid_map
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import init_solver_carry, pack_qp

MODEL = ModelConfig(length=0.12, width=0.06, Ts=0.05)


def count_ops(fn) -> int:
    """``chip_smoke.count_ops`` without its device synchronise."""
    total = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in chip_smoke._ELEMENTWISE:
                first = out[0] if isinstance(out, (tuple, list)) else out
                total[0] += first.numel()
            elif name in chip_smoke._REDUCTIONS:
                total[0] += args[0].numel()
            return out

    with Counter():
        fn()
    return total[0]


def qp_inputs(B, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g)
    return (0.5 + r(B, N), 0.5 * torch.randn(B, N, generator=g),
            0.05 + 0.01 * r(B, N), -0.05 - 0.1 * r(B, N), 0.05 + 0.1 * r(B, N),
            0.01 * torch.randn(B, 3, generator=g),
            0.3 * torch.randn(B, N, generator=g))


CASES = [(1, 4, (30, 6, 10)), (3, 4, (30, 6, 10)), (2, 7, (5, 2, 0)),
         (3, 5, (3, 1, 4))]


@pytest.mark.parametrize("B,N,budget", CASES)
def test_k1_and_k3_counts_equal_the_twins(B, N, budget):
    it, ro, po = budget
    cfg = MPCConfig(N=N, solver=SolverConfig(iterations=it, rho_updates=ro,
                                             polish_iters=po))
    v, k, ds, lb, ub, x0, kp = qp_inputs(B, N)
    warm = init_solver_carry(N, B, device="cpu")
    args = (v, k, ds, lb, ub, x0, kp, warm, cfg.solver, cfg, MODEL)
    twin = lambda: admm_cuda.solve_mpc_qp_fused_plain(*args)
    assert k1.ops(B, N, it, ro, po) == count_ops(twin)
    assert k1.nbytes(B, N) == chip_smoke.nbytes(args, twin())
    sq = pack_qp(assemble_ltv_qp(cfg, MODEL, x0[:, 0], x0[:, 1], kp,
                                 Corridor(ub, lb, None, None), (v, k, ds)))
    twin3 = lambda: admm_cuda.solve_ltv_qp_structured_plain(sq, warm,
                                                            cfg.solver)
    assert k3.ops(B, N, it, ro, po) == count_ops(twin3)
    assert k3.nbytes(B, N) == chip_smoke.nbytes((sq, warm), twin3())


@pytest.mark.parametrize("B,H,W,nb,N,K", [(1, 40, 24, 5, 3, 8),
                                          (2, 70, 13, 9, 2, 5)])
def test_k6_counts_equal_the_twin(B, H, W, nb, N, K):
    g = torch.Generator().manual_seed(1)
    occ = (torch.rand(B, H, W, generator=g) > 0.3).float()
    pk = mapping.pack_rows(occ)
    ri = lambda hi, *s: torch.randint(0, hi, s, generator=g, dtype=torch.int32)
    args = (ri(W, B, nb), ri(H, B, nb), torch.rand(B, nb, generator=g) < 0.5,
            ri(W, B, N, K), ri(H, B, N, K))
    twin = lambda: mapping.writeback_extract_packed_plain(pk, *args)
    WR = (H + 31) // 32
    assert k6.ops(B, WR, W, nb) == count_ops(twin)
    assert k6.nbytes(B, WR, W, nb, N, K) == chip_smoke.nbytes(pk, args, twin())


def test_k7_counts_the_in_range_cells_of_chip_smoke():
    rng = np.random.default_rng(3)
    occ = (rng.random((60, 50)) > 0.2).astype(np.float32)
    grid = make_grid_map(occ, (-0.3, 0.1), 0.02, device="cpu")
    cells = k7.boundary_cells(grid.occ)
    x = torch.tensor(rng.uniform(-0.2, 0.6, 7), dtype=torch.float32)
    y = torch.tensor(rng.uniform(0.2, 1.1, 7), dtype=torch.float32)
    n = k7.in_range(cells, (-0.3, 0.1), 0.02, 0.4, x, y, chunk=3)
    # chip_smoke.k7_ops on the global table (padding rows never in range)
    from multi_purpose_mpc_tpu_torch.ops import lidar

    table = lidar.occupied_cell_table(grid.occ)
    cx, cy = lidar._sensor(grid, x, y)
    nb = 4
    ux = torch.zeros(7, nb)
    cell_ops, pair_ops = chip_smoke.k7_ops(grid, table, None, cx, cy, ux, ux,
                                           ux, 0.4)
    assert pair_ops == n * nb * chip_smoke.K7_PAIR_OPS
    assert k7.ops(n, nb) == n * (chip_smoke.K7_CELL_OPS
                                 + nb * chip_smoke.K7_PAIR_OPS)
    assert torch.equal(cells, table[:cells.shape[0]].long())
