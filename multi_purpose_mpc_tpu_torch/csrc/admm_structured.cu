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
// Design: one thread per lane, as K1.  What bounds it on an H100 is K1's
// bound: the per-lane state in local memory, a dependent chain of scalar
// flops per iteration; the QP load (~1.2 KB per lane at N = 30) is one
// pass over device memory.

#include "admm_core.cuh"

namespace {

__global__ void __launch_bounds__(32) admm_structured_kernel(
    const float* __restrict__ AB, const float* __restrict__ beq,
    const float* __restrict__ Pd, const float* __restrict__ qv,
    const float* __restrict__ lw, const float* __restrict__ uw,
    const float* __restrict__ W0, const float* __restrict__ Zw0,
    const float* __restrict__ Yeq0, const float* __restrict__ Yw0,
    const float* __restrict__ rho0, float* __restrict__ W_out,
    float* __restrict__ Zw_out, float* __restrict__ Yeq_out,
    float* __restrict__ Yw_out, float* __restrict__ rho_out,
    float* __restrict__ rp_out, float* __restrict__ rd_out, int B, int N,
    SolverParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int S = N + 1;
  Lane L;
  Iterate it, pol;
  L.N = N;

  // ---- load the lane's QP: AB (N, 3, 5), beq (N+1, 3), rest (N+1, 5) ----
  const float* ab = AB + (size_t)b * N * NX * NW;
  for (int n = 0; n < N; ++n)
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NW; ++j) L.AB[n][i][j] = ab[(n * NX + i) * NW + j];
  const size_t w5 = (size_t)b * S * NW, w3 = (size_t)b * S * NX;
  for (int s = 0; s < S; ++s) {
    for (int i = 0; i < NX; ++i) L.beq[s][i] = beq[w3 + s * NX + i];
    for (int j = 0; j < NW; ++j) {
      L.Pd[s][j] = Pd[w5 + s * NW + j];
      L.qv[s][j] = qv[w5 + s * NW + j];
      L.lw[s][j] = lw[w5 + s * NW + j];
      L.uw[s][j] = uw[w5 + s * NW + j];
    }
  }

  load_warm(L, it, W0, Zw0, Yeq0, Yw0, b);
  const float rho = admm_solve(L, it, pol, p, rho0[b]);
  store_outputs(L, it, rho, b, W_out, Zw_out, Yeq_out, Yw_out, rho_out,
                rp_out, rd_out);
}

}  // namespace

extern "C" int admm_structured_launch(
    const float* AB, const float* beq, const float* Pd, const float* qv,
    const float* lw, const float* uw, const float* W0, const float* Zw0,
    const float* Yeq0, const float* Yw0, const float* rho0, float* W,
    float* Zw, float* Yeq, float* Yw, float* rho, float* rp, float* rd,
    int B, int N, SolverParams p, void* stream) {
  if (N < 1 || N > NMAX) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  admm_structured_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      AB, beq, Pd, qv, lw, uw, W0, Zw0, Yeq0, Yw0, rho0, W, Zw, Yeq, Yw, rho,
      rp, rd, B, N, p);
  return (int)cudaGetLastError();
}
