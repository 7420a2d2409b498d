"""Fused per-lane map write-back + scanline extraction: kernels K5 and K6
(port of ``multi_purpose_mpc_tpu/ops/mapping_pallas.py``).

Each step of the per-lane LiDAR fleet writes every lane's scan hits into
its own map and reads the N horizon scanlines back out of the UPDATED map.
One launch does both, one block per lane:

* K5 (``csrc/writeback_extract.cu``) on float32 grids (B, H, W): copy the
  lane's grid, zero its hit cells, read the (N, K) samples;
* K6 (``csrc/writeback_extract_packed.cu``) on grids bit-packed 32 rows per
  int32 word (B, ceil(H/32), W): the lane's words sit in shared memory,
  hit bits are cleared with ``atomicAnd``, the words are stored and the
  samples read from the shared copy.  The rollout carry never unpacks:
  32 KB per Sim_Track lane instead of 1 MB.

The packed layout is the JAX package's: bit ``j`` of word ``(r, c)`` is
cell ``(32 r + j, c)``; rows past H are free (1).  The TPU kernels' bf16
one-hot write-back and ``row0`` windows are Mosaic devices and were left
out, and so is ``pad_rows``: the kernels read the grid directly.

Beside each kernel, its plain PyTorch version (the CPU path and what the
card is held against):

* K5 plain: :func:`~.lidar.apply_observation_masks` of the hit mask (the
  JAX package's ``fleet_writeback(clear_free=False, shared=False)``), then
  :func:`~.corridor_extract.extract_occ_gather`;
* K6 plain: :func:`unpack_rows`, K5 plain, :func:`pack_rows`.

A wrapper sends CPU tensors to the plain version and CUDA tensors to the
kernel; it raises on a failed build or launch and never falls back.

Hits come in clipped to ``[0, H)`` x ``[0, W)``; rows past H are never
written, so pad rows stay free.
"""

from __future__ import annotations

import ctypes

import torch

from multi_purpose_mpc_tpu_torch.ops.corridor_extract import extract_occ_gather
from multi_purpose_mpc_tpu_torch.ops.lidar import (_point_mask,
                                                   apply_observation_masks)
from multi_purpose_mpc_tpu_torch.utils import kernels

_BITS = [1 << j for j in range(31)] + [-(1 << 31)]  # bit j of an int32 word


def pack_rows(occ: torch.Tensor) -> torch.Tensor:
    """(..., H, W) binary float grid -> (..., ceil(H/32), W) int32, rows
    padded with free cells to a multiple of 32; bit j of word (r, c) is
    cell (32 r + j, c)."""
    H, W = occ.shape[-2:]
    Hp = (H + 31) // 32 * 32
    bits = occ > 0.5
    if Hp != H:
        pad = torch.ones(occ.shape[:-2] + (Hp - H, W), dtype=torch.bool,
                         device=occ.device)
        bits = torch.cat([bits, pad], -2)
    bits = bits.reshape(occ.shape[:-2] + (Hp // 32, 32, W))
    words = torch.zeros(occ.shape[:-2] + (Hp // 32, W), dtype=torch.int32,
                        device=occ.device)
    for j, b in enumerate(_BITS):
        words |= bits[..., j, :].to(torch.int32) * b
    return words


def unpack_rows(occ_pk: torch.Tensor, H: int) -> torch.Tensor:
    """(..., WR, W) int32 row-packed -> (..., H, W) float32 binary grid."""
    WR, W = occ_pk.shape[-2:]
    sh = torch.arange(32, dtype=torch.int32, device=occ_pk.device)[:, None]
    # an arithmetic shift fills the top bits with the sign; ``& 1`` keeps
    # only bit j, so row 31 (the sign bit) unpacks exactly
    bits = (occ_pk[..., :, None, :] >> sh) & 1
    out = bits.reshape(occ_pk.shape[:-2] + (WR * 32, W)).to(torch.float32)
    return out[..., :H, :]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def writeback_extract_plain(occ, hpx, hpy, hit, px, py):
    """K5's plain version: occ (B, H, W) float32 per-lane grids; hpx/hpy
    (B, nb) int32 hit cells clipped in-bounds; hit (B, nb) bool; px/py
    (B, N, K) int32 clipped scanline samples.  Returns ``(new_occ, vals)``:
    every hit cell zeroed, then the (B, N, K) values of the updated
    grids."""
    H, W = occ.shape[-2:]
    new_occ = apply_observation_masks(
        occ, _point_mask(hpy, hpx, hit, H, W, shared=False), None)
    return new_occ, extract_occ_gather(new_occ, px, py)


def writeback_extract_packed_plain(occ_pk, hpx, hpy, hit, px, py):
    """K6's plain version: ``occ_pk`` (B, WR, W) int32 (:func:`pack_rows`);
    other arguments as :func:`writeback_extract_plain`.  Returns
    ``(new_occ_pk, vals)``."""
    occ = unpack_rows(occ_pk, occ_pk.shape[-2] * 32)
    new_occ, vals = writeback_extract_plain(occ, hpx, hpy, hit, px, py)
    return pack_rows(new_occ), vals


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _library(name: str):
    fn = getattr(kernels.load(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(occ, dtype, hpx, hpy, hit, px, py, name):
    dev = occ.device
    if dev.type != "cuda" or occ.dtype != dtype or occ.dim() != 3:
        raise ValueError(f"{name} needs a (B, rows, W) {dtype} CUDA grid, got "
                         f"{tuple(occ.shape)} {occ.dtype} on {dev}")
    Bsz = occ.shape[0]
    if hpx.dim() != 2 or hpx.shape[0] != Bsz or hpy.shape != hpx.shape \
            or hit.shape != hpx.shape:
        raise ValueError(f"hpx/hpy/hit must be ({Bsz}, nb) alike, got "
                         f"{tuple(hpx.shape)}, {tuple(hpy.shape)}, "
                         f"{tuple(hit.shape)}")
    if px.dim() != 3 or px.shape[0] != Bsz or py.shape != px.shape:
        raise ValueError(f"px/py must be ({Bsz}, N, K) alike, got "
                         f"{tuple(px.shape)} and {tuple(py.shape)}")
    for t, want, label in ((occ, dtype, "occ"), (hpx, torch.int32, "hpx"),
                           (hpy, torch.int32, "hpy"), (hit, torch.bool, "hit"),
                           (px, torch.int32, "px"), (py, torch.int32, "py")):
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{label}: expected contiguous {want} on {dev}, "
                             f"got {t.dtype} on {t.device}")


def _launch(name, occ, hpx, hpy, hit, px, py, rows):
    Bsz, _, W = occ.shape
    N, K = px.shape[1:]
    new_occ = torch.empty_like(occ)
    vals = torch.empty((Bsz, N, K), dtype=torch.float32, device=occ.device)
    rc = _library(name)(occ.data_ptr(), hpx.data_ptr(), hpy.data_ptr(),
                        hit.data_ptr(), px.data_ptr(), py.data_ptr(),
                        new_occ.data_ptr(), vals.data_ptr(), Bsz,
                        hpx.shape[1], N * K, rows, W,
                        torch.cuda.current_stream(occ.device).cuda_stream)
    kernels.check_launch(rc, f"{name}_kernel")
    return new_occ, vals


def writeback_extract_cuda(occ, hpx, hpy, hit, px, py):
    """Launch K5 on the current stream; same outputs as
    :func:`writeback_extract_plain`."""
    _check(occ, torch.float32, hpx, hpy, hit, px, py, "writeback_extract_cuda")
    out = _launch("writeback_extract", occ, hpx, hpy, hit, px, py,
                  occ.shape[1])
    writeback_extract_cuda.launches += 1
    return out


writeback_extract_cuda.launches = 0


def writeback_extract_packed_cuda(occ_pk, hpx, hpy, hit, px, py):
    """Launch K6 on the current stream; same outputs as
    :func:`writeback_extract_packed_plain`."""
    _check(occ_pk, torch.int32, hpx, hpy, hit, px, py,
           "writeback_extract_packed_cuda")
    out = _launch("writeback_extract_packed", occ_pk, hpx, hpy, hit, px, py,
                  occ_pk.shape[1] * 32)
    writeback_extract_packed_cuda.launches += 1
    return out


writeback_extract_packed_cuda.launches = 0


def writeback_extract(occ, hpx, hpy, hit, px, py):
    """Hit write-back + scanline extraction on float32 per-lane grids: the
    plain version for CPU tensors, kernel K5 for CUDA tensors."""
    if occ.device.type == "cpu":
        return writeback_extract_plain(occ, hpx, hpy, hit, px, py)
    return writeback_extract_cuda(occ, hpx, hpy, hit, px, py)


def writeback_extract_packed(occ_pk, hpx, hpy, hit, px, py):
    """The same on bit-packed grids: the plain version for CPU tensors,
    kernel K6 for CUDA tensors."""
    if occ_pk.device.type == "cpu":
        return writeback_extract_packed_plain(occ_pk, hpx, hpy, hit, px, py)
    return writeback_extract_packed_cuda(occ_pk, hpx, hpy, hit, px, py)
