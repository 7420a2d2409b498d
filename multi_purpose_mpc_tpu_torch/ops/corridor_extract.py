"""Fleet-scale scanline occupancy extraction for dynamic grids, with kernel
K4 (port of ``multi_purpose_mpc_tpu/ops/corridor_extract.py``).

The scanline sample coordinates are static per waypoint (the border points
are path data), so they live in a precomputed :class:`ScanlineTable`; the
per-step work of a dynamic-grid fleet is "read the occupancy at K static
pixels for the N horizon waypoints of each lane", then find the free runs.

Kernel K4 replaces the Pallas TPU kernel ``_make_extract_kernel`` (body
``scanline_window_rows``, entry ``extract_occ_pallas``).  The TPU kernel
keeps each lane's grid in VMEM and reads it as a bf16 one-hot contraction
over 128-row windows, a Mosaic device that is exact only because the grid
holds 0/1; on Hopper the read is a direct load (``csrc/extract_occ.cu``),
and ``row0`` / ``window_rows``, which exist only for Mosaic's aligned
dynamic slices, are left out of the table.

* :func:`extract_occ_gather` — the plain PyTorch version (``occ[py, px]``),
  the JAX package's semantic reference;
* :func:`extract_occ_cuda` — the CUDA kernel;
* :func:`extract_occ` — a CPU tensor goes to the plain version, a CUDA
  tensor to the kernel (or the wrapper raises).

The free runs of the extracted samples (the free-segment candidates) are
kernel K8 on the card (``csrc/free_runs.cu``, :func:`free_runs_cuda`),
which reads the static table's ``inb``, ``cx`` and ``cy`` rows through the
horizon indices itself; :func:`horizon_segments_from_table` dispatches, and
its plain route is :func:`horizon_segments` on the gathered rows.

What bounds K4 on the card: one 4-byte read from a grid that sits in L2
(a 500 x 500 float32 grid is 1 MB) per output, against 12 bytes of
device-memory traffic per output (px, py in, the value out): at the main
path's (4096, 30, 128) that is 15.7 M reads and ~190 MB moved per step, so
it is bound by device-memory bandwidth on the index and output streams.
One thread per output, consecutive threads on consecutive samples, keeps
those streams coalesced.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import NamedTuple

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.ops.constraints import (SegmentCandidates,
                                                         segments_from_samples)
from multi_purpose_mpc_tpu_torch.ops.grid import GridMap, m2w
from multi_purpose_mpc_tpu_torch.ops.path import PathData
from multi_purpose_mpc_tpu_torch.ops.rays import sample_line
from multi_purpose_mpc_tpu_torch.utils import kernels


class ScanlineTable(NamedTuple):
    """Static per-waypoint scanline sample data, all (n_wp, K).

    ``px``/``py`` are in-bounds (clipped) int32 pixel coords; ``inb`` marks
    samples that were genuinely inside the grid (out-of-bounds samples read
    as occupied, matching :func:`~.grid.lookup`); ``cx``/``cy`` are the
    world coordinates of the sample cell centres, from the raw pixel coords
    (reference_path.py:488-518)."""

    px: torch.Tensor
    py: torch.Tensor
    inb: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor


def build_scanline_table(grid: GridMap, path: PathData,
                         n_samples: int) -> ScanlineTable:
    """Scanline sample coordinates for every waypoint (static: depends only
    on the grid geometry and the static border points)."""
    s = sample_line(grid, path.border_ub[:, 0], path.border_ub[:, 1],
                    path.border_lb[:, 0], path.border_lb[:, 1], n_samples)
    h, w = grid.occ.shape
    inb = (s.px >= 0) & (s.px < w) & (s.py >= 0) & (s.py < h)
    cx, cy = m2w(grid, s.px, s.py)
    return ScanlineTable(px=s.px.clamp(0, w - 1), py=s.py.clamp(0, h - 1),
                         inb=inb, cx=cx, cy=cy)


def horizon_tables(table: ScanlineTable, idx: torch.Tensor) -> ScanlineTable:
    """The (B, N) horizon rows of the static table: (B, N, K) each."""
    idx = idx.long()
    return ScanlineTable(*(t[idx] for t in table))


def horizon_pixels(table: ScanlineTable, idx: torch.Tensor):
    """``(px, py)`` of the (B, N) horizon rows, (B, N, K) int32 each: what
    the extraction reads (the free runs read the rest of the rows through
    ``idx`` themselves)."""
    idx = idx.long()
    return table.px[idx], table.py[idx]


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def extract_occ_gather(occ: torch.Tensor, px: torch.Tensor,
                       py: torch.Tensor) -> torch.Tensor:
    """occ (H, W) shared or (B, H, W) per lane; px/py (B, N, K) in-bounds
    pixel coords -> (B, N, K) occupancy."""
    if occ.dim() == 2:
        return occ[py.long(), px.long()]
    lane = torch.arange(occ.shape[0], device=occ.device)[:, None, None]
    return occ[lane, py.long(), px.long()]


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _library():
    fn = kernels.load("extract_occ").extract_occ_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def extract_occ_cuda(occ: torch.Tensor, px: torch.Tensor,
                     py: torch.Tensor) -> torch.Tensor:
    """Launch ``extract_occ_kernel`` on the current stream; same output as
    :func:`extract_occ_gather`.  Raises on anything the kernel does not
    take, and on a failed launch."""
    dev = occ.device
    if dev.type != "cuda" or occ.dtype != torch.float32:
        raise ValueError(f"extract_occ_cuda needs a float32 CUDA grid, got "
                         f"{occ.dtype} on {dev}")
    if px.dim() != 3 or px.shape != py.shape:
        raise ValueError(f"px/py must be (B, N, K) alike, got {tuple(px.shape)}"
                         f" and {tuple(py.shape)}")
    for name, t in (("px", px), ("py", py)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous int32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    Bsz, N, K = px.shape
    if occ.dim() not in (2, 3) or (occ.dim() == 3 and occ.shape[0] != Bsz):
        raise ValueError(f"occ must be (H, W) or ({Bsz}, H, W), got "
                         f"{tuple(occ.shape)}")
    if not occ.is_contiguous():
        raise ValueError("occ must be contiguous")
    H, W = occ.shape[-2:]
    out = torch.empty((Bsz, N, K), dtype=torch.float32, device=dev)
    rc = _library()(occ.data_ptr(), px.data_ptr(), py.data_ptr(),
                    out.data_ptr(), Bsz, N * K, H, W, int(occ.dim() == 2),
                    torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(rc, "extract_occ_kernel")
    extract_occ_cuda.launches += 1
    return out


extract_occ_cuda.launches = 0


def extract_occ(occ: torch.Tensor, px: torch.Tensor,
                py: torch.Tensor) -> torch.Tensor:
    """Occupancy values at the horizon scanline samples: the plain version
    for a CPU grid, kernel K4 for a CUDA grid."""
    if occ.device.type == "cpu":
        return extract_occ_gather(occ, px, py)
    return extract_occ_cuda(occ, px, py)


def fleet_dynamic_segments(occ: torch.Tensor, table: ScanlineTable,
                           idx: torch.Tensor, min_width,
                           max_segments: int) -> SegmentCandidates:
    """Per-lane free-segment candidates from per-lane (B, H, W) or shared
    (H, W) dynamic grids; ``idx`` (B, N) horizon waypoint indices.  Returns
    candidates with leading (B, N)."""
    vals = extract_occ(occ, *horizon_pixels(table, idx))
    return horizon_segments_from_table(vals, table, idx, min_width,
                                       max_segments)


def horizon_segments(vals: torch.Tensor, h: ScanlineTable, min_width,
                     max_segments: int) -> SegmentCandidates:
    """Free-segment candidates from extracted scanline values ``vals``
    (B, N, K) and their horizon rows ``h`` (:func:`horizon_tables`): the
    plain version of kernel K8 (:func:`horizon_segments_from_table`)."""
    vals = torch.where(h.inb, vals, torch.zeros_like(vals))  # OOB: occupied
    return segments_from_samples(vals, h.cx, h.cy, min_width, max_segments)


# K8 takes scanlines of at most this many samples (8 words of a warp's ballot)
FREE_RUNS_MAX_K = 256


def _free_runs_library():
    fn = kernels.load("free_runs").free_runs_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_float,
                                             ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def free_runs_cuda(vals: torch.Tensor, table: ScanlineTable,
                   idx: torch.Tensor, min_width,
                   max_segments: int) -> SegmentCandidates:
    """Launch ``free_runs_kernel`` (K8) on the current stream: the output of
    ``horizon_segments(vals, horizon_tables(table, idx), min_width,
    max_segments)``, bit for bit.  ``vals`` (B, N, K) float32, ``idx``
    (B, N) int64, the table's ``inb`` (bool), ``cx`` and ``cy`` (float32)
    (n_wp, K), all contiguous on one CUDA device; ``min_width`` a number,
    rounded to float32 as torch rounds a Python scalar it compares a
    float32 tensor with.  Raises on anything the kernel does not take, and
    on a failed launch."""
    dev = vals.device
    if dev.type != "cuda" or vals.dim() != 3:
        raise ValueError(f"free_runs_cuda needs (B, N, K) CUDA vals, got "
                         f"{tuple(vals.shape)} on {dev}")
    Bsz, N, K = vals.shape
    if not 0 < K <= FREE_RUNS_MAX_K:
        raise ValueError(f"free_runs_cuda takes 1-{FREE_RUNS_MAX_K} samples a "
                         f"scanline, got {K}")
    n_wp = table.inb.shape[0]
    for name, t, dtype, shape in (
            ("vals", vals, torch.float32, (Bsz, N, K)),
            ("idx", idx, torch.int64, (Bsz, N)),
            ("table.inb", table.inb, torch.bool, (n_wp, K)),
            ("table.cx", table.cx, torch.float32, (n_wp, K)),
            ("table.cy", table.cy, torch.float32, (n_wp, K))):
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if n_wp == 0 or max_segments < 1:
        raise ValueError(f"free_runs_cuda needs a table row and a segment "
                         f"slot, got {n_wp} rows, {max_segments} slots")
    if isinstance(min_width, torch.Tensor) or not isinstance(min_width,
                                                             numbers.Real):
        raise ValueError(f"min_width must be a number, got {type(min_width)}")
    S = max_segments
    ub = torch.empty((Bsz, N, S, 2), dtype=torch.float32, device=dev)
    lb = torch.empty_like(ub)
    valid = torch.empty((Bsz, N, S), dtype=torch.bool, device=dev)
    rc = _free_runs_library()(
        vals.data_ptr(), idx.data_ptr(), table.inb.data_ptr(),
        table.cx.data_ptr(), table.cy.data_ptr(), Bsz * N, n_wp, K,
        float(np.float32(min_width)), S, ub.data_ptr(), lb.data_ptr(),
        valid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(rc, "free_runs_kernel")
    free_runs_cuda.launches += 1
    return SegmentCandidates(ub_xy=ub, lb_xy=lb, valid=valid)


free_runs_cuda.launches = 0


def horizon_segments_from_table(vals: torch.Tensor, table: ScanlineTable,
                                idx: torch.Tensor, min_width,
                                max_segments: int) -> SegmentCandidates:
    """Free-segment candidates of the extracted scanline values ``vals``
    (B, N, K) on the static table's rows ``idx`` (B, N): for CPU tensors
    the plain version, :func:`horizon_segments` on the gathered rows; for
    CUDA tensors kernel K8 (:func:`free_runs_cuda`), which reads the rows
    through ``idx`` itself."""
    if vals.device.type == "cpu":
        return horizon_segments(vals, horizon_tables(table, idx), min_width,
                                max_segments)
    return free_runs_cuda(vals, table, idx.long().contiguous(), min_width,
                          max_segments)
