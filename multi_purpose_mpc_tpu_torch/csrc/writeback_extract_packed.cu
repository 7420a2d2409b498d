// Kernel K6: K5's per-lane hit write-back + scanline extraction on grids
// bit-packed 32 rows per 32-bit word: bit j of word (r, c) is cell
// (32 r + j, c), 1 = free; rows past H are free padding.
//
// Replaces the Pallas TPU kernel
// multi_purpose_mpc_tpu/ops/mapping_pallas.py (_make_fused_kernel_packed,
// entry writeback_extract_packed).  The plain PyTorch version is
// multi_purpose_mpc_tpu_torch/ops/mapping.py::writeback_extract_packed_plain
// (unpack -> K5's plain version -> pack); this kernel computes exactly that
// without ever unpacking the grid.  The TPU kernel's unpack into an f32
// VMEM scratch, its bf16 one-hot write-back and its row0 windows are
// Mosaic devices and are not carried over.
//
// Design: one block per lane.  The lane's words (16 x 500 x 4 = 32,000 B on
// Sim_Track, 24 x 867 x 4 = 83,232 B on Real_Track) are loaded into dynamic
// shared memory; each hit beam clears its bit with atomicAnd, because two
// beams on different rows of one word race on a read-modify-write (beams
// that hit one wall hit neighbouring cells); after __syncthreads() the
// words are stored and the samples read from the shared copy as
// (word >> (y & 31)) & 1.  Words are unsigned, so the shift is logical and
// row 31 (the int32 sign bit) reads exactly.
//
// What bounds it on an H100: device-memory bandwidth on the index and value
// streams (12 bytes per sample, 9 per beam) and the packed words (2 x 32 KB
// per Sim_Track lane).  Hit and sample coordinates are clamped into the
// stored rows, so a bad index cannot leave the lane's words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // the H100's per-block shared memory limit

__global__ void __launch_bounds__(kThreads) writeback_extract_packed_kernel(
    const unsigned int* __restrict__ pk, const int* __restrict__ hpx,
    const int* __restrict__ hpy, const bool* __restrict__ hit,
    const int* __restrict__ px, const int* __restrict__ py,
    unsigned int* __restrict__ new_pk, float* __restrict__ vals, int nb,
    int NK, int rows, int W) {
  extern __shared__ unsigned int words[];
  const int64_t lane = blockIdx.x;
  const int nwords = (rows >> 5) * W;
  const unsigned int* src = pk + lane * nwords;
  for (int i = threadIdx.x; i < nwords; i += blockDim.x) words[i] = src[i];
  __syncthreads();

  // write-back: clear the bit of every cell a beam hit
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int64_t j = lane * nb + i;
    if (hit[j]) {
      const int x = min(max(hpx[j], 0), W - 1);
      const int y = min(max(hpy[j], 0), rows - 1);
      atomicAnd(&words[(y >> 5) * W + x], ~(1u << (y & 31)));
    }
  }
  __syncthreads();

  unsigned int* dst = new_pk + lane * nwords;
  for (int i = threadIdx.x; i < nwords; i += blockDim.x) dst[i] = words[i];

  // extraction from the updated shared copy
  for (int i = threadIdx.x; i < NK; i += blockDim.x) {
    const int64_t j = lane * NK + i;
    const int x = min(max(px[j], 0), W - 1);
    const int y = min(max(py[j], 0), rows - 1);
    vals[j] = (float)((words[(y >> 5) * W + x] >> (y & 31)) & 1u);
  }
}

}  // namespace

extern "C" int writeback_extract_packed_launch(
    const int* pk, const int* hpx, const int* hpy, const bool* hit,
    const int* px, const int* py, int* new_pk, float* vals, int B, int nb,
    int NK, int rows, int W, void* stream) {
  if (B < 0 || nb < 0 || NK < 0 || rows <= 0 || (rows & 31) || W <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = (int64_t)(rows >> 5) * W * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        writeback_extract_packed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  writeback_extract_packed_kernel<<<B, kThreads, (size_t)smem,
                                    (cudaStream_t)stream>>>(
      reinterpret_cast<const unsigned int*>(pk), hpx, hpy, hit, px, py,
      reinterpret_cast<unsigned int*>(new_pk), vals, nb, NK, rows, W);
  return (int)cudaGetLastError();
}
