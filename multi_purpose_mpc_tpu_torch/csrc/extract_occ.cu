// Kernel K4: occupancy at each lane's horizon scanline samples.
//
// Replaces the Pallas TPU kernel multi_purpose_mpc_tpu/ops/corridor_extract.py
// (_make_extract_kernel with scanline_window_rows, entry extract_occ_pallas).
// The plain PyTorch version is
// multi_purpose_mpc_tpu_torch/ops/corridor_extract.py::extract_occ_gather,
// occ[py, px]: this kernel computes exactly that.  The TPU kernel's bf16
// one-hot contraction over 128-row windows is a Mosaic device (exact only
// because the grid holds 0/1) and is not carried over.
//
// Design: one thread per output (lane, stage, sample); consecutive threads
// read consecutive px/py entries and write consecutive outputs, so the
// index and output streams are coalesced, and the grid reads (1 MB for a
// 500 x 500 shared grid) hit L2.  The per-lane grid offset is computed in
// 64 bits: B * H * W passes 2^31 at about 8,600 Sim_Track lanes.
//
// What bounds it on an H100: device-memory bandwidth on px, py and the
// output (12 bytes per output); there is no arithmetic to speak of.
// Coordinates come in clipped (ScanlineTable); they are clamped again here
// so that a bad index cannot read outside the grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void extract_occ_kernel(const float* __restrict__ occ,
                                   const int* __restrict__ px,
                                   const int* __restrict__ py,
                                   float* __restrict__ out, int64_t total,
                                   int NK, int H, int W, int shared) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t lane = i / NK;
  const int x = min(max(px[i], 0), W - 1);
  const int y = min(max(py[i], 0), H - 1);
  const int64_t base = shared ? 0 : lane * (int64_t)H * (int64_t)W;
  out[i] = occ[base + (int64_t)y * W + x];
}

}  // namespace

extern "C" int extract_occ_launch(const float* occ, const int* px,
                                  const int* py, float* out, int B, int NK,
                                  int H, int W, int shared, void* stream) {
  if (B < 0 || NK < 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * NK;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  extract_occ_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      occ, px, py, out, total, NK, H, W, shared);
  return (int)cudaGetLastError();
}
