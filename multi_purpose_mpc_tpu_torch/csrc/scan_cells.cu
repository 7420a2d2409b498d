// Kernel K7: the sweep of the `cells` LiDAR scan.
//
// Replaces the sweep of multi_purpose_mpc_tpu/ops/lidar.py::scan_fleet
// (backend "cells", :239-350): XLA code in the JAX package, a lax.scan over
// 2048-cell chunks that XLA fuses into one loop with reductions (it is not
// a Pallas kernel).  The plain PyTorch version is
// multi_purpose_mpc_tpu_torch/ops/lidar.py::cells_min_plain; this kernel
// computes exactly that, bit for bit.
//
// What it computes: for each lane and beam, the lexicographic minimum of
// (d, pid) over the lane's candidate cells that pass the corner-span test
//   along = dx * ux + dy * uy > 0,
//   |perp| = |dy * ux - dx * uy| <= support,
//   0 < d = sqrt(dx * dx + dy * dy) < range,
// with (dx, dy) the cell centre (m2w) less the sensor and pid the float32
// packed id py * W + px; (1e9, 1e9) where no cell passes.  The plain
// version keeps the first chunk's winner across chunks and the smallest
// id within one; that is this minimum because table rows are in
// ascending id order (ops/lidar.py: occupied_cell_table, waypoint_cell_table).
// The lexicographic minimum does not depend on the order the cells are
// visited in, which is what lets this kernel compact them in any order.
//
// Every float operation is the plain version's, rounded where it rounds:
// the _rn intrinsics keep each product and sum its own rounding whatever
// the compiler's contraction flags, sqrt is IEEE.  m2w is the plain
// version's (px + 0.5) * resolution + origin, three roundings, on the
// int32 table itself, so the kernel reads 8 bytes a cell and no float
// table is built.
//
// A table pruned per waypoint holds the cells within range + slack of each
// waypoint, so it is exact for a sensor within the slack of its lane's
// waypoint.  With a fallback (ops/lidar.py: CellTable), a lane whose
// sensor lies past `reach` of its waypoint sweeps the global table
// instead (the decision in float32, each product and sum rounded, as the
// plain version's), and its block adds one to the fallback counter.
//
// Design: one block per lane, a thread per beam (ceil(nb / 32) warps; past
// 256 beams a thread keeps 2, 4 or 8 beams).  The block reads its lane's
// table row through wp_id (no (B, K, 2) gather) in tiles of 8 cells a
// thread: each cell's dx, dy and d are computed once, by one thread, and
// the cells in range are compacted into shared memory (warp ballot, one
// shared atomic a warp) as float4 (dx, dy, d, pid).  Then every thread
// sweeps the tile's compacted cells for its beams, each read a broadcast,
// keeping its running (d, pid) minimum in registers.  Nothing of size
// (lanes, cells, beams) exists anywhere.
//
// What bounds it on an H100: operations.  The table is a few MB (L2
// resident) and the outputs 8 bytes a beam; the work is the per-cell
// prologue over all B x K candidates and ~11 operations a pair test over
// the in-range cells only (a few hundred to a few thousand a lane on the
// Sim_Track tables at a 1 m range).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CELLS_PER_THREAD = 8;  // a tile: 8 cells a thread
constexpr int MAX_THREADS = 256;
constexpr float BIG = 1e9f;  // the plain version's sentinel

template <int BPT>
__global__ void __launch_bounds__(MAX_THREADS) scan_cells_kernel(
    const int2* __restrict__ cells, int rows, int K,
    const int* __restrict__ wp_id, const int2* __restrict__ every, int M,
    const float* __restrict__ waypoints, float reach2,
    unsigned long long* __restrict__ fallbacks,
    const float* __restrict__ origin, const float* __restrict__ resolution,
    int W,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ ux, const float* __restrict__ uy,
    const float* __restrict__ support, float range, int nb,
    float* __restrict__ out_d, float* __restrict__ out_pid) {
  extern __shared__ float4 tile[];
  __shared__ int count;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lid = tid & 31;

  // a global table is every lane's row 0; a clamped wp_id cannot read
  // outside the table
  const int row = wp_id ? min(max(wp_id[lane], 0), rows - 1) : 0;
  const int2* rc = cells + (int64_t)row * K;
  const float res = *resolution, ox = origin[0], oy = origin[1];
  const float sx = cx[lane], sy = cy[lane];
  if (every) {  // past the reach of its waypoint: the global table
    const float wx = __fsub_rn(sx, waypoints[2 * row]);
    const float wy = __fsub_rn(sy, waypoints[2 * row + 1]);
    if (__fadd_rn(__fmul_rn(wx, wx), __fmul_rn(wy, wy)) > reach2) {
      rc = every;
      K = M;
      if (tid == 0) atomicAdd(fallbacks, 1ull);
    }
  }

  float bux[BPT], buy[BPT], bsup[BPT], bd[BPT], bp[BPT];
#pragma unroll
  for (int b = 0; b < BPT; ++b) {
    const int beam = tid + b * nthreads;
    const int64_t i = (int64_t)lane * nb + beam;
    const bool on = beam < nb;
    // an idle slot can never pass: along = 0 is not > 0
    bux[b] = on ? ux[i] : 0.f;
    buy[b] = on ? uy[i] : 0.f;
    bsup[b] = on ? support[i] : -1.f;
    bd[b] = BIG;
    bp[b] = BIG;
  }

  const int tile_cells = nthreads * CELLS_PER_THREAD;
  for (int t0 = 0; t0 < K; t0 += tile_cells) {
    if (tid == 0) count = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CELLS_PER_THREAD; ++k) {
      const int c = t0 + k * nthreads + tid;
      bool keep = false;
      float4 rec = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < K) {
        const int2 p = rc[c];
        const float gx = __fadd_rn(
            __fmul_rn(__fadd_rn(__int2float_rn(p.x), 0.5f), res), ox);
        const float gy = __fadd_rn(
            __fmul_rn(__fadd_rn(__int2float_rn(p.y), 0.5f), res), oy);
        const float dx = __fsub_rn(gx, sx);
        const float dy = __fsub_rn(gy, sy);
        const float d =
            __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        keep = d < range && d > 0.f;
        // the id in int32 arithmetic that wraps, as torch's does
        const int pid = (int)((unsigned)p.y * (unsigned)W + (unsigned)p.x);
        rec = make_float4(dx, dy, d, __int2float_rn(pid));
      }
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      int base = 0;
      if (lid == 0 && m) base = atomicAdd(&count, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (keep) tile[base + __popc(m & ((1u << lid) - 1u))] = rec;
    }
    __syncthreads();
    const int n = count;
    for (int j = 0; j < n; ++j) {
      const float4 r = tile[j];  // dx, dy, d, pid: a broadcast read
#pragma unroll
      for (int b = 0; b < BPT; ++b) {
        const float along =
            __fadd_rn(__fmul_rn(r.x, bux[b]), __fmul_rn(r.y, buy[b]));
        const float perp =
            fabsf(__fsub_rn(__fmul_rn(r.y, bux[b]), __fmul_rn(r.x, buy[b])));
        const bool better = along > 0.f && perp <= bsup[b] &&
                            (r.z < bd[b] || (r.z == bd[b] && r.w < bp[b]));
        bd[b] = better ? r.z : bd[b];
        bp[b] = better ? r.w : bp[b];
      }
    }
    __syncthreads();  // the next tile overwrites this one
  }

#pragma unroll
  for (int b = 0; b < BPT; ++b) {
    const int beam = tid + b * nthreads;
    if (beam < nb) {
      const int64_t i = (int64_t)lane * nb + beam;
      out_d[i] = bd[b];
      out_pid[i] = bp[b];
    }
  }
}

template <int BPT>
cudaError_t launch(int threads, int B, cudaStream_t stream, const int2* cells,
                   int rows, int K, const int* wp_id, const int2* every,
                   int M, const float* waypoints, float reach2,
                   unsigned long long* fallbacks, const float* origin,
                   const float* resolution, int W, const float* cx,
                   const float* cy, const float* ux, const float* uy,
                   const float* support, float range, int nb, float* out_d,
                   float* out_pid) {
  const size_t smem = sizeof(float4) * threads * CELLS_PER_THREAD;
  scan_cells_kernel<BPT><<<B, threads, smem, stream>>>(
      cells, rows, K, wp_id, every, M, waypoints, reach2, fallbacks, origin,
      resolution, W, cx, cy, ux, uy, support, range, nb, out_d, out_pid);
  return cudaGetLastError();
}

}  // namespace

// cells: (rows, K, 2) int32 pixel coords (rows = 1 for a global table,
// wp_id NULL); wp_id: (B,) int32 row of each lane; every: NULL, or the
// (M, 2) int32 global table a lane falls back to past reach2 (squared) of
// its row's waypoint (waypoints (rows, 2) float32), counted in
// *fallbacks (int64); origin (2,), resolution () float32 on the device;
// cx, cy (B,); ux, uy, support (B, nb); outputs (B, nb) float32.  Returns
// a cudaError_t (0 on success).
extern "C" int scan_cells_launch(const int* cells, int rows, int K,
                                 const int* wp_id, const int* every, int M,
                                 const float* waypoints, float reach2,
                                 long long* fallbacks, const float* origin,
                                 const float* resolution, int W,
                                 const float* cx, const float* cy,
                                 const float* ux, const float* uy,
                                 const float* support, float range, int B,
                                 int nb, float* out_d, float* out_pid,
                                 void* stream) {
  if (B < 0 || K < 0 || rows <= 0 || nb <= 0 || W <= 0 ||
      (every && (M < 0 || !wp_id || !waypoints || !fallbacks)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int bpt = 1;
  while (bpt < 8 && (nb + bpt - 1) / bpt > MAX_THREADS) bpt *= 2;
  const int per = (nb + bpt - 1) / bpt;
  if (per > MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int threads = (per + 31) / 32 * 32;
  const int2* c2 = reinterpret_cast<const int2*>(cells);
  cudaStream_t s = (cudaStream_t)stream;
  const int2* e2 = reinterpret_cast<const int2*>(every);
  unsigned long long* fb = reinterpret_cast<unsigned long long*>(fallbacks);
#define SCAN_CELLS_ARGS                                                     \
  threads, B, s, c2, rows, K, wp_id, e2, M, waypoints, reach2, fb, origin, \
      resolution, W, cx, cy, ux, uy, support, range, nb, out_d, out_pid
  switch (bpt) {
    case 1: return (int)launch<1>(SCAN_CELLS_ARGS);
    case 2: return (int)launch<2>(SCAN_CELLS_ARGS);
    case 4: return (int)launch<4>(SCAN_CELLS_ARGS);
    default: return (int)launch<8>(SCAN_CELLS_ARGS);
  }
#undef SCAN_CELLS_ARGS
}
