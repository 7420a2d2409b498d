// Kernel K3: the structured ADMM solve of pre-assembled per-lane QPs.
//
// Replaces the Pallas TPU kernel multi_purpose_mpc_tpu/ops/admm_pallas.py
// (_make_kernel with build=None, entry solve_ltv_qp_pallas, launched
// through _dispatch_tiles).  It is kernel K1's ADMM without the in-kernel
// assembly and the violation floor: each lane's QP arrives in the stage
// layout (ops/ltv_qp.py::StageQP), so per-lane cost weights (tuning
// sweeps) and any other assembly reach the same solver.  The plain PyTorch
// version is ops/admm_cuda.py::solve_ltv_qp_structured_plain (pack_qp,
// admm_rounds from the carried rho, the residuals); the ADMM is
// admm_core.cuh, built with -fmad=false, so the two agree operation for
// operation.
//
// Design: K1's (admm_core.cuh): one warp per lane, up to four lanes per
// block, the lane's state in shared memory, N a runtime argument up to the
// horizon that shared memory bounds.  The lane's QP (~1.2 KB at N = 30)
// is copied into shared memory with coalesced loads: the shared arrays
// have the public [stage][element] layout.  What bounds it on an H100 is
// K1's bound: the latency of the stage recurrences of every ADMM
// iteration, ~12k dependent stage steps per lane, with 16 lanes resident
// per SM.
// SolverConfig(stage_solver="cr") launches the instantiation with block
// cyclic reduction as the stage solver, with K1's CR lane and launch
// shape.

#include <limits.h>

#include "admm_core.cuh"

namespace {

template <bool CR>
__global__ void __launch_bounds__(
    WARP * (CR ? MAX_CR_LANES_PER_BLOCK : MAX_LANES_PER_BLOCK))
    admm_structured_kernel(
    const float* __restrict__ AB, const float* __restrict__ beq,
    const float* __restrict__ Pd, const float* __restrict__ qv,
    const float* __restrict__ lw, const float* __restrict__ uw,
    const float* __restrict__ W0, const float* __restrict__ Zw0,
    const float* __restrict__ Yeq0, const float* __restrict__ Yw0,
    const float* __restrict__ rho0, Outputs out, int B, int N,
    SolverParams p) {
  extern __shared__ float4 smem4[];
  const int w = threadIdx.x / WARP;
  const int b = blockIdx.x * (blockDim.x / WARP) + w;
  if (b >= B) return;  // whole warps only: a ragged block idles its tail
  const Lane L = lane_at<CR>(reinterpret_cast<float*>(smem4), w, N);
  const int S = N + 1;

  // ---- the lane's QP: AB (N, 3, 5), beq (N+1, 3), rest (N+1, 5) ----
  const size_t ab0 = (size_t)b * N * NX * NW;
  for (int e = L.t; e < S * NX * NW; e += WARP)
    L.AB[e] = e < N * NX * NW ? AB[ab0 + e] : 0.f;  // stage N has no [A|B]
  const size_t w5 = (size_t)b * S * NW, w3 = (size_t)b * S * NX;
  for (int e = L.t; e < S * NX; e += WARP) L.beq[e] = beq[w3 + e];
  for (int e = L.t; e < S * NW; e += WARP) {
    L.Pd[e] = Pd[w5 + e];
    L.qv[e] = qv[w5 + e];
    L.lw[e] = lw[w5 + e];
    L.uw[e] = uw[w5 + e];
  }
  __syncwarp();

  load_warm(L, W0, Zw0, Yeq0, Yw0, b);
  admm_solve<CR>(L, p, rho0[b], out, b);
}

template <bool CR>
int launch(const float* AB, const float* beq, const float* Pd,
           const float* qv, const float* lw, const float* uw,
           const float* W0, const float* Zw0, const float* Yeq0,
           const float* Yw0, const float* rho0, const Outputs& out, int B,
           int N, const SolverParams& p, cudaStream_t stream) {
  int lanes = 0, smem = 0;
  const cudaError_t err =
      launch_shape<CR>(admm_structured_kernel<CR>, N, B, &lanes, &smem,
                       nullptr);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  admm_structured_kernel<CR><<<(B + lanes - 1) / lanes, WARP * lanes,
                               (size_t)smem, stream>>>(
      AB, beq, Pd, qv, lw, uw, W0, Zw0, Yeq0, Yw0, rho0, out, B, N, p);
  return (int)cudaGetLastError();
}

}  // namespace

// cyclic_reduction: 0 = the Schur recursion, 1 = block cyclic reduction
// (SolverConfig.stage_solver == "cr").
extern "C" int admm_structured_launch(
    const float* AB, const float* beq, const float* Pd, const float* qv,
    const float* lw, const float* uw, const float* W0, const float* Zw0,
    const float* Yeq0, const float* Yw0, const float* rho0, float* W,
    float* Zw, float* Yeq, float* Yw, float* rho, float* rp, float* rd,
    int B, int N, int cyclic_reduction, SolverParams p, void* stream) {
  const Outputs out{W, Zw, Yeq, Yw, rho, rp, rd};
  const auto run = cyclic_reduction ? launch<true> : launch<false>;
  return run(AB, beq, Pd, qv, lw, uw, W0, Zw0, Yeq0, Yw0, rho0, out, B, N, p,
             (cudaStream_t)stream);
}

// The launch shape the launcher picks at horizon N for a batch that fills
// the card (cyclic_reduction as above): lanes a block and the lanes
// resident on one SM.
extern "C" int admm_structured_occupancy(int N, int cyclic_reduction,
                                         int* lanes, int* per_sm) {
  int smem = 0;
  if (cyclic_reduction)
    return (int)launch_shape<true>(admm_structured_kernel<true>, N,
                                   INT_MAX, lanes, &smem, per_sm);
  return (int)launch_shape<false>(admm_structured_kernel<false>, N,
                                  INT_MAX, lanes, &smem, per_sm);
}
