// Kernel K5: per-lane LiDAR hit write-back fused with scanline extraction,
// on float32 occupancy grids (1 = free, 0 = occupied).
//
// Replaces the Pallas TPU kernel
// multi_purpose_mpc_tpu/ops/mapping_pallas.py (_make_fused_kernel, entry
// writeback_extract_pallas).  The plain PyTorch version is
// multi_purpose_mpc_tpu_torch/ops/mapping.py::writeback_extract_plain
// (hit mask -> where -> occ[lane, py, px]); this kernel computes exactly
// that.  The TPU kernel's bf16 one-hot write-back matmul and its 8-aligned
// row0 windows are Mosaic devices and are not carried over.
//
// Design: one block per lane, in three phases separated by __syncthreads()
// (which makes the block's global stores visible to the whole block):
//   1. copy the lane's grid to new_occ, coalesced (16-byte vectors when the
//      lane's rows are 16-byte aligned, as on Sim_Track's 500 x 500 grid);
//   2. each hit beam stores 0 at its cell; two beams on one cell store the
//      same value, so the race is benign;
//   3. read the N x K scanline samples back out of the UPDATED grid.
// Lane offsets are 64-bit: a B = 4096 Sim_Track stack is 4.1 GB.
//
// What bounds it on an H100: device-memory bandwidth.  Per lane it reads
// and writes the whole grid (2 x 1 MB on Sim_Track) against 12 bytes per
// sample and 9 per beam; there is no arithmetic.  Hit and sample
// coordinates come in clipped and are clamped again, so a bad index cannot
// leave the lane's grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) writeback_extract_kernel(
    const float* __restrict__ occ, const int* __restrict__ hpx,
    const int* __restrict__ hpy, const bool* __restrict__ hit,
    const int* __restrict__ px, const int* __restrict__ py, float* new_occ,
    float* __restrict__ vals, int nb, int NK, int H, int W) {
  const int64_t lane = blockIdx.x;
  const int64_t cells = (int64_t)H * W;
  const float* src = occ + lane * cells;
  float* dst = new_occ + lane * cells;

  // 1. copy
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst);
  if ((cells & 3) == 0 && (align & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int64_t i = threadIdx.x; i < cells / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int64_t i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();

  // 2. write-back: every cell a beam hit becomes occupied
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int64_t j = lane * nb + i;
    if (hit[j]) {
      const int x = min(max(hpx[j], 0), W - 1);
      const int y = min(max(hpy[j], 0), H - 1);
      dst[(int64_t)y * W + x] = 0.0f;
    }
  }
  __syncthreads();

  // 3. extraction from the updated grid (plain loads: it was written above)
  for (int i = threadIdx.x; i < NK; i += blockDim.x) {
    const int64_t j = lane * NK + i;
    const int x = min(max(px[j], 0), W - 1);
    const int y = min(max(py[j], 0), H - 1);
    vals[j] = dst[(int64_t)y * W + x];
  }
}

}  // namespace

extern "C" int writeback_extract_launch(const float* occ, const int* hpx,
                                        const int* hpy, const bool* hit,
                                        const int* px, const int* py,
                                        float* new_occ, float* vals, int B,
                                        int nb, int NK, int H, int W,
                                        void* stream) {
  if (B < 0 || nb < 0 || NK < 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  writeback_extract_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      occ, hpx, hpy, hit, px, py, new_occ, vals, nb, NK, H, W);
  return (int)cudaGetLastError();
}
