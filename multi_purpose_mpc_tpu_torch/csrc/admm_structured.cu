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

#include "admm_core.cuh"

namespace {

__global__ void __launch_bounds__(WARP * MAX_LANES_PER_BLOCK) admm_structured_kernel(
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
  const Lane L = lane_at(reinterpret_cast<float*>(smem4), w, N);
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
  admm_solve(L, p, rho0[b], out, b);
}

}  // namespace

extern "C" int admm_structured_launch(
    const float* AB, const float* beq, const float* Pd, const float* qv,
    const float* lw, const float* uw, const float* W0, const float* Zw0,
    const float* Yeq0, const float* Yw0, const float* rho0, float* W,
    float* Zw, float* Yeq, float* Yw, float* rho, float* rp, float* rd,
    int B, int N, SolverParams p, void* stream) {
  const int lanes = N < 1 ? 0 : lanes_per_block(N);
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int smem = lanes * lane_floats(N + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      admm_structured_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(admm_structured_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const Outputs out{W, Zw, Yeq, Yw, rho, rp, rd};
  admm_structured_kernel<<<(B + lanes - 1) / lanes, WARP * lanes,
                           (size_t)smem, (cudaStream_t)stream>>>(
      AB, beq, Pd, qv, lw, uw, W0, Zw0, Yeq0, Yw0, rho0, out, B, N, p);
  return (int)cudaGetLastError();
}
