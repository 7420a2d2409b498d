"""Kernel K2: corridor continuity selection, one thread per candidate segment.

Replaces the Pallas TPU kernel ``multi_purpose_mpc_tpu/ops/corridor_pallas.py``
(``_make_kernel`` via ``select_call_lanes_last``).  For each lane it scans
the N horizon stages of its gathered horizon-table block (B, N, F): it
projects the previously selected borders forward, picks the valid free
segment that continues them (the widest at n = 0), takes signed orthogonal
distances from the sign of the cross product, shrinks by the safety margin
and collapses infeasible stages to 0.

* :func:`corridor_select_plain` — the plain PyTorch twin, written with the
  kernel's formulas (cross-product sign instead of atan2 + wrap, sqrt
  instead of hypot, strict ``<`` so ties keep the first segment);
* :func:`corridor_select_cuda` — ``csrc/corridor_select.cu`` (built
  without FMA contraction: it agrees with the twin bit for bit, NaN equal
  to NaN);
* :func:`corridor_select` — CPU tensors to the twin, CUDA tensors to the
  kernel; no fallback.

What bounds the kernel on the card: the bytes, B N F 4 read and B N 6 4
written (8.2 us at B = 4096, N = 30, S = 8 and 3.35 TB/s), and the latency
of a lane's sequential stage chain.  The kernel gives every candidate
segment of a lane a thread (16 lanes a 128-thread block at S = 8), stages
the block's lanes through shared memory in chunks of 8 stages, a ring of 4
filled 3 chunks ahead (cp.async, 16-byte pieces, coalesced, independent of
N), keeps the chain free of branches (a branch-free correctly rounded
square root, :func:`sqrt_mismatches`), picks the first strict minimum with
a warp-shuffle reduction and stores each chunk's outputs coalesced.
"""

from __future__ import annotations

import ctypes

import torch

from multi_purpose_mpc_tpu_torch.ops.constraints import Corridor
from multi_purpose_mpc_tpu_torch.utils import kernels

NPOSE = 7  # x, y, cos psi, sin psi, ds, cos psi_prev, sin psi_prev
_BIG = 1e9


def block_width(S: int) -> int:
    """Columns F of a horizon-table row for ``S`` segment candidates."""
    return NPOSE + 5 * S + 3


def corridor_select_plain(blk: torch.Tensor, S: int,
                          safety_margin: float) -> Corridor:
    """The twin, on a (B, N, F) horizon block."""
    sm = safety_margin
    ub0, lb0, va0 = NPOSE, NPOSE + 2 * S, NPOSE + 4 * S
    Bsz, N, _ = blk.shape
    zero = torch.zeros(Bsz, dtype=blk.dtype, device=blk.device)
    ub_prev_x = ub_prev_y = lb_prev_x = lb_prev_y = zero
    ubs, lbs, cubs, clbs = [], [], [], []
    for n in range(N):
        row = blk[:, n]
        x, y, cp, sp = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
        proj_x = row[:, 4] * row[:, 5]
        proj_y = row[:, 4] * row[:, 6]
        ub_pw_x, ub_pw_y = ub_prev_x + proj_x, ub_prev_y + proj_y
        lb_pw_x, lb_pw_y = lb_prev_x + proj_x, lb_prev_y + proj_y

        best = torch.full_like(x, _BIG)
        sel_ubx, sel_uby, sel_lbx, sel_lby = x, y, x, y
        for s in range(S):
            ux, uy = row[:, ub0 + 2 * s], row[:, ub0 + 2 * s + 1]
            lx, ly = row[:, lb0 + 2 * s], row[:, lb0 + 2 * s + 1]
            if n == 0:  # widest segment: minimize negative squared width
                dx, dy = ux - lx, uy - ly
                score = -(dx * dx + dy * dy)
            else:  # closest to the forward-projected previous borders
                ax, ay = ux - ub_pw_x, uy - ub_pw_y
                bx, by = lx - lb_pw_x, ly - lb_pw_y
                score = (torch.sqrt(ax * ax + ay * ay)
                         + torch.sqrt(bx * bx + by * by)) * 0.5
            better = (row[:, va0 + s] > 0.5) & (score < best)
            best = torch.where(better, score, best)
            sel_ubx = torch.where(better, ux, sel_ubx)
            sel_uby = torch.where(better, uy, sel_uby)
            sel_lbx = torch.where(better, lx, sel_lbx)
            sel_lby = torch.where(better, ly, sel_lby)

        dux, duy = sel_ubx - x, sel_uby - y
        dlx, dly = sel_lbx - x, sel_lby - y
        ub = torch.sign(duy * cp - dux * sp) * torch.sqrt(dux * dux + duy * duy) - sm
        lb = torch.sign(dly * cp - dlx * sp) * torch.sqrt(dlx * dlx + dly * dly) + sm
        infeasible = ub < lb
        ub = torch.where(infeasible, zero, ub)
        lb = torch.where(infeasible, zero, lb)

        dx_o, dy_o = -sp, cp
        ubs.append(ub)
        lbs.append(lb)
        cubs.append(torch.stack([x + ub * dx_o, y + ub * dy_o], -1))
        clbs.append(torch.stack([x + lb * dx_o, y + lb * dy_o], -1))
        ub_prev_x, ub_prev_y = x + (ub + sm) * dx_o, y + (ub + sm) * dy_o
        lb_prev_x, lb_prev_y = x + (lb - sm) * dx_o, y + (lb - sm) * dy_o
    return Corridor(ub=torch.stack(ubs, 1), lb=torch.stack(lbs, 1),
                    border_ub=torch.stack(cubs, 1),
                    border_lb=torch.stack(clbs, 1))


def _library():
    fn = kernels.load("corridor_select").corridor_select_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def corridor_select_cuda(blk: torch.Tensor, S: int,
                         safety_margin: float) -> Corridor:
    """Launch ``corridor_select_kernel`` on the current stream."""
    if blk.device.type != "cuda" or blk.dtype != torch.float32:
        raise ValueError(f"corridor_select_cuda needs a float32 CUDA tensor, "
                         f"got {blk.dtype} on {blk.device}")
    if blk.dim() != 3 or blk.shape[2] != block_width(S):
        raise ValueError(f"horizon block must be (B, N, {block_width(S)}), "
                         f"got {tuple(blk.shape)}")
    if not blk.is_contiguous():
        raise ValueError("horizon block must be contiguous")
    Bsz, N, F = blk.shape
    ub = torch.empty((Bsz, N), dtype=torch.float32, device=blk.device)
    lb = torch.empty_like(ub)
    cub = torch.empty((Bsz, N, 2), dtype=torch.float32, device=blk.device)
    clb = torch.empty_like(cub)
    rc = _library()(blk.data_ptr(), ub.data_ptr(), lb.data_ptr(),
                    cub.data_ptr(), clb.data_ptr(), Bsz, N, S, F,
                    float(safety_margin),
                    torch.cuda.current_stream(blk.device).cuda_stream)
    kernels.check_launch(rc, "corridor_select_kernel")
    corridor_select_cuda.launches += 1
    return Corridor(ub=ub, lb=lb, border_ub=cub, border_lb=clb)


corridor_select_cuda.launches = 0


def sqrt_mismatches(device="cuda") -> int:
    """Float inputs (of all 2^32) on which the kernel's branch-free square
    root differs from ``sqrtf``, NaN equal to NaN; 0 is what keeps K2 bit
    for bit equal to the plain version."""
    fn = kernels.load("corridor_select").corridor_select_sqrt_mismatches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    count = torch.zeros(1, dtype=torch.int64, device=device)
    kernels.check_launch(fn(count.data_ptr(),
                            torch.cuda.current_stream(count.device).cuda_stream),
                         "sqrt_check_kernel")
    return int(count.item())


def corridor_select(blk: torch.Tensor, S: int, safety_margin: float) -> Corridor:
    """Corridor selection on a (B, N, F) horizon block: the twin for a CPU
    tensor, the CUDA kernel for a CUDA tensor."""
    if blk.device.type == "cpu":
        return corridor_select_plain(blk, S, safety_margin)
    return corridor_select_cuda(blk, S, safety_margin)
