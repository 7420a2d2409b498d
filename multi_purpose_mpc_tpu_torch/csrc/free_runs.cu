// Kernel K8: the free runs of the horizon scanlines (free-segment candidates).
//
// Replaces XLA code of the JAX package, not a pallas_call:
// multi_purpose_mpc_tpu/ops/constraints.py::segments_from_samples, reached
// through ops/corridor_extract.py's horizon segmenting.  The plain PyTorch
// version is multi_purpose_mpc_tpu_torch/ops/corridor_extract.py::
// horizon_segments(vals, horizon_tables(table, idx), ...), which calls
// ops/constraints.py::segments_from_samples; this kernel computes exactly
// that, bit for bit.
//
// What it computes, per scanline (lane b, stage n) of K samples on the
// table row w = idx[b, n]:
//   free[k] = inb[w, k] && vals[b, n, k] > 0.5;
//   run r (in order along k) from its start s_r to its end e_r;
//   ub_i = max(s_r - 1, 0), lb_i = min(e_r + 1, K - 1) (the occupied or
//   border samples that delimit it), its endpoints (cx, cy)[w, ub_i] and
//   (cx, cy)[w, lb_i];
//   kept where hypotf(ubx - lbx, uby - lby) > min_width (min_width rounded
//   to float32, as torch rounds a Python scalar it compares with);
//   the first S kept runs compacted into slots 0.., later slots zero and
//   invalid.
// The endpoints are copied, never computed, and the width is the plain
// version's one hypot of two differences, so the output is bitwise the
// plain version's wherever hypotf here rounds as torch.hypot does on the
// card (held by the tests, planted ties included).
//
// Design: one warp a scanline, 8 scanlines a block.  Lane l reads samples
// 32 j + l (j < K / 32, each a coalesced 128-byte row of vals; the vals
// and the table row's inb are loaded independently, so every load of the
// scanline is in flight at once), and one ballot a word gives every lane
// the scanline's free mask in registers.  Starts and ends are
// free & ~(free << 1) and free & ~(free >> 1), with the carry across
// words.  The lane that holds a run's start takes the run: its end is the
// first end bit at or after the start (a find-first-set in the mask
// words), so no lane searches for the r-th run.  Words are taken in
// order, and in a word the lanes' runs are in order along k, so a ballot
// over a word's kept runs and a popcount of the lanes below give each its
// slot, as the plain version compacts them.  No scratch in device or
// shared memory, no int64 arithmetic, no synchronisation beyond the
// warp's.
//
// What bounds it on an H100: device-memory bandwidth, K x 4 bytes of vals
// read and S x 17 bytes written a scanline; the table rows read through idx
// (n_wp x K x 9 bytes, 230 KB on Sim_Track) stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // scanlines a block
constexpr int kMaxWords = 8;  // K <= 256

__global__ void __launch_bounds__(32 * kWarps) free_runs_kernel(
    const float* __restrict__ vals, const int64_t* __restrict__ idx,
    const bool* __restrict__ inb, const float* __restrict__ cx,
    const float* __restrict__ cy, int64_t scanlines, int rows, int K,
    float min_width, int S, float2* __restrict__ ub_xy,
    float2* __restrict__ lb_xy, bool* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int64_t sl = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (sl >= scanlines) return;  // the whole warp
  // a clamped index cannot read outside the table
  const int64_t w = min(max(idx[sl], (int64_t)0), (int64_t)(rows - 1));
  const float* v = vals + sl * K;
  const bool* in_row = inb + w * K;
  const float* cx_row = cx + w * K;
  const float* cy_row = cy + w * K;

  float x[kMaxWords];
  bool in[kMaxWords];
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    const int k = 32 * j + lane;
    x[j] = k < K ? v[k] : 0.f;
    in[j] = k < K && in_row[k];
  }
  unsigned f[kMaxWords];
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j)
    f[j] = __ballot_sync(0xffffffffu, in[j] && x[j] > 0.5f);
  unsigned st[kMaxWords], en[kMaxWords];
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    const unsigned prev = (f[j] << 1) | (j > 0 ? f[j - 1] >> 31 : 0u);
    const unsigned next =
        (f[j] >> 1) | (j + 1 < kMaxWords ? f[j + 1] << 31 : 0u);
    st[j] = f[j] & ~prev;
    en[j] = f[j] & ~next;
  }

  float2* ub_out = ub_xy + sl * S;
  float2* lb_out = lb_xy + sl * S;
  bool* valid_out = valid + sl * S;
  int kept = 0;  // warp-uniform
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    if (32 * j >= K || kept >= S) break;  // the whole warp
    bool keep = false;
    float2 ub = make_float2(0.f, 0.f), lb = ub;
    if ((st[j] >> lane) & 1u) {  // a run starts at sample 32 j + lane
      const unsigned here = en[j] & (~0u << lane);
      int e = here ? 32 * j + __ffs(here) - 1 : -1;
#pragma unroll
      for (int jj = j + 1; jj < kMaxWords; ++jj)
        e = (e < 0 && en[jj]) ? 32 * jj + __ffs(en[jj]) - 1 : e;
      const int ub_i = max(32 * j + lane - 1, 0);
      const int lb_i = min(e + 1, K - 1);
      ub = make_float2(cx_row[ub_i], cy_row[ub_i]);
      lb = make_float2(cx_row[lb_i], cy_row[lb_i]);
      keep = hypotf(__fsub_rn(ub.x, lb.x), __fsub_rn(ub.y, lb.y)) > min_width;
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    const int slot = kept + __popc(m & ((1u << lane) - 1u));
    if (keep && slot < S) {
      ub_out[slot] = ub;
      lb_out[slot] = lb;
      valid_out[slot] = true;
    }
    kept += __popc(m);
  }
  for (int s = min(kept, S) + lane; s < S; s += 32) {
    ub_out[s] = make_float2(0.f, 0.f);
    lb_out[s] = make_float2(0.f, 0.f);
    valid_out[s] = false;
  }
}

}  // namespace

// vals: (scanlines, K) float32; idx: (scanlines,) int64 table rows; inb
// (rows, K) bool, cx, cy (rows, K) float32; outputs ub_xy, lb_xy
// (scanlines, S, 2) float32 and valid (scanlines, S) bool.  Returns a
// cudaError_t (0 on success).
extern "C" int free_runs_launch(const float* vals, const int64_t* idx,
                                const bool* inb, const float* cx,
                                const float* cy, int64_t scanlines, int rows,
                                int K, float min_width, int S, float* ub_xy,
                                float* lb_xy, bool* valid, void* stream) {
  if (scanlines < 0 || rows <= 0 || K <= 0 || K > 32 * kMaxWords || S <= 0)
    return (int)cudaErrorInvalidValue;
  if (scanlines == 0) return 0;
  const int64_t blocks = (scanlines + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  free_runs_kernel<<<(unsigned)blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      vals, idx, inb, cx, cy, scanlines, rows, K, min_width, S,
      reinterpret_cast<float2*>(ub_xy), reinterpret_cast<float2*>(lb_xy),
      valid);
  return (int)cudaGetLastError();
}
