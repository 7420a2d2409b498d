// Kernel K1: fused LTV-MPC QP assembly + ADMM + violation floor.
//
// Replaces the Pallas TPU kernel multi_purpose_mpc_tpu/ops/admm_pallas.py
// (_make_kernel with build=_make_builder, entry solve_mpc_qp_fused with
// return_floor=True).  The plain PyTorch twin is
// multi_purpose_mpc_tpu_torch/ops/admm_cuda.py::solve_mpc_qp_fused_plain
// (QP assembly there, solver core in ops/ltv_qp.py); this file follows it
// operation for operation: the assembly and floor here, the ADMM in
// admm_core.cuh (shared with kernel K3), all built with -fmad=false so
// a*b+c rounds twice as the twin does.
//
// Design: one warp per lane, up to four lanes per block, the lane's state
// in shared memory (admm_core.cuh: 14 KB at N = 30), N a runtime argument
// up to the horizon that shared memory bounds (lanes_per_block).  Thread t
// assembles stages t, t + 32, ... from the public (B, N, ...) inputs with
// coalesced loads; the violation floor's interval recursion runs in stage
// order on the whole warp and thread 0 writes it.
//
// What bounds it on an H100: the stage recurrences.  Every ADMM iteration
// runs a forward and a backward substitution over the N + 1 stages, and
// each stage step is a dependent chain (two 5-term sums in the plain
// version's left-to-right order, two rounds of shuffles), so one lane's
// solve is ~12k such steps in a row: latency, not arithmetic or memory.
// A lane alone takes ~1.7 ms at N = 30; 4 blocks of 4 lanes fit on an SM
// (shared memory, 128 registers a thread), and B = 4096 runs as two waves
// of 16 warps per SM, each warp still waiting on its chain most of the
// time.  Device-memory traffic is one read of the inputs and one write of
// the outputs.
//
// SolverConfig(stage_solver="cr") launches the instantiation with block
// cyclic reduction as the stage solver (admm_core.cuh: cr_factor,
// cr_solve; the TPU kernel's factor_cr / solve_cr, admm_pallas.py:509-659):
// 2 x log2(M + 1) level steps a solve instead of 2 x N stage steps, each
// level parallel over its stages, at about twice the block arithmetic and
// 17 KB of shared memory a lane at N = 30 (M = 31 padded stages).

#include "admm_core.cuh"

struct AdmmParams {  // mirrored by ctypes in ops/admm_cuda.py::_Params
  SolverParams s;
  float Q[3], QN[3], R[2], xmin[3], xmax[3];
  float v_min, v_max, ay_max, kmax;
};

namespace {

template <bool CR>
__global__ void __launch_bounds__(WARP * MAX_LANES_PER_BLOCK) admm_fused_kernel(
    const float* __restrict__ v_ref, const float* __restrict__ kappa_ref,
    const float* __restrict__ delta_s, const float* __restrict__ lb_c,
    const float* __restrict__ ub_c, const float* __restrict__ kappa_pred,
    const float* __restrict__ x0, const float* __restrict__ W0,
    const float* __restrict__ Zw0, const float* __restrict__ Yeq0,
    const float* __restrict__ Yw0, const float* __restrict__ rho0,
    Outputs out, float* __restrict__ floor_out, int B, int N,
    AdmmParams p) {
  extern __shared__ float4 smem4[];
  const int w = threadIdx.x / WARP;
  const int b = blockIdx.x * (blockDim.x / WARP) + w;
  if (b >= B) return;  // whole warps only: a ragged block idles its tail
  const Lane L = lane_at<CR>(reinterpret_cast<float*>(smem4), w, N);

  const float* v = v_ref + (size_t)b * N;
  const float* k = kappa_ref + (size_t)b * N;
  const float* ds = delta_s + (size_t)b * N;
  const float* lbc = lb_c + (size_t)b * N;
  const float* ubc = ub_c + (size_t)b * N;
  const float* kp = kappa_pred + (size_t)b * N;
  const float* xb = x0 + (size_t)b * NX;
  const float inf = INFINITY;

  // ---- in-kernel assembly (the TPU kernel's _make_builder), per stage ----
  for (int s = L.t; s <= N; s += WARP) {
    const bool last = s == N;
    float* beq = L.beq + s * NX;
    if (s == 0) {
      for (int i = 0; i < NX; ++i) beq[i] = -xb[i];
    } else {
      const float vv = v[s - 1], kk = k[s - 1], dd = ds[s - 1];
      beq[0] = 0.f;
      beq[1] = dd * kk;
      beq[2] = (-2.0f * dd) / vv;
    }
    float* ab = L.AB + s * 15;
    if (last) {
      for (int e = 0; e < 15; ++e) ab[e] = 0.f;  // stage N has no [A|B]
    } else {
      const float vv = v[s], kk = k[s], dd = ds[s];
      const float row0[NW] = {1.f, dd, 0.f, 0.f, 0.f};
      const float row1[NW] = {(-(kk * kk)) * dd, 1.f, 0.f, 0.f, dd};
      const float row2[NW] = {(-(kk / vv)) * dd, 0.f, 1.f, (-dd) / (vv * vv), 0.f};
      for (int j = 0; j < NW; ++j) {
        ab[j] = row0[j];
        ab[NW + j] = row1[j];
        ab[2 * NW + j] = row2[j];
      }
    }
    float* Pd = L.Pd + s * NW;
    float* qv = L.qv + s * NW;
    float* lw = L.lw + s * NW;
    float* uw = L.uw + s * NW;
    Pd[0] = last ? p.QN[0] : p.Q[0];
    Pd[1] = last ? p.QN[1] : p.Q[1];
    Pd[2] = last ? p.QN[2] : p.Q[2];
    Pd[3] = last ? 0.f : p.R[0];
    Pd[4] = last ? 0.f : p.R[1];
    float ey = 0.f;
    if (s > 0) {
      const float ctr = 0.5f * (lbc[s - 1] + ubc[s - 1]);
      ey = (last ? -p.QN[0] : -p.Q[0]) * ctr;
    }
    qv[0] = ey;
    qv[1] = 0.f;
    qv[2] = 0.f;
    qv[3] = last ? 0.f : (-p.R[0]) * v[s];
    qv[4] = last ? 0.f : (-p.R[1]) * k[s];
    lw[0] = s == 0 ? xb[0] : lbc[s - 1];
    uw[0] = s == 0 ? xb[0] : ubc[s - 1];
    lw[1] = p.xmin[1];
    uw[1] = p.xmax[1];
    lw[2] = p.xmin[2];
    uw[2] = p.xmax[2];
    if (last) {
      lw[3] = -inf; uw[3] = inf;
      lw[4] = -inf; uw[4] = inf;
    } else {
      lw[3] = p.v_min;
      uw[3] = pmin(sqrtf(p.ay_max / (fabsf(kp[s]) + 1e-12f)), p.v_max);
      lw[4] = -p.kmax;
      uw[4] = p.kmax;
    }
  }

  // ---- certified violation floor by interval reachability (in order) ----
  {
    float y_lo = xb[0], y_hi = xb[0], p_lo = xb[1], p_hi = xb[1];
    float viol_max = 0.f;
    bool width_ok = true;
    for (int n = 0; n < N; ++n) {
      const float kn = k[n], dn = ds[n];
      const float ny_lo = y_lo + dn * p_lo;
      const float ny_hi = y_hi + dn * p_hi;
      const float c = (-(kn * kn)) * dn;
      const float t_lo = pmin(c * y_lo, c * y_hi);
      const float t_hi = pmax(c * y_lo, c * y_hi);
      const float np_lo = (t_lo + p_lo) + dn * ((-p.kmax) - kn);
      const float np_hi = (t_hi + p_hi) + dn * (p.kmax - kn);
      const float viol = pmax(pmax(lbc[n] - ny_hi, ny_lo - ubc[n]), 0.f);
      viol_max = pmax(viol_max, viol);
      y_lo = ny_lo; y_hi = ny_hi; p_lo = np_lo; p_hi = np_hi;
      width_ok = width_ok && ((ubc[n] - lbc[n]) > 0.f);
    }
    if (L.t == 0) floor_out[b] = width_ok ? viol_max : 0.f;
  }
  __syncwarp();

  // ---- warm start, solve, outputs (admm_core.cuh) ----
  load_warm(L, W0, Zw0, Yeq0, Yw0, b);
  admm_solve<CR>(L, p.s, rho0[b], out, b);
}

// Launch one instantiation (CR: the stage solver) on `stream`.
template <bool CR>
int launch(const float* v_ref, const float* kappa_ref, const float* delta_s,
           const float* lb_c, const float* ub_c, const float* kappa_pred,
           const float* x0, const float* W0, const float* Zw0,
           const float* Yeq0, const float* Yw0, const float* rho0,
           const Outputs& out, float* floor_out, int B, int N,
           const AdmmParams& p, cudaStream_t stream) {
  const int lanes = N < 1 ? 0 : lanes_per_block(N, CR);
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int smem = lanes * lane_floats(N + 1, CR) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      admm_fused_kernel<CR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(admm_fused_kernel<CR>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  admm_fused_kernel<CR><<<(B + lanes - 1) / lanes, WARP * lanes,
                          (size_t)smem, stream>>>(
      v_ref, kappa_ref, delta_s, lb_c, ub_c, kappa_pred, x0, W0, Zw0, Yeq0,
      Yw0, rho0, out, floor_out, B, N, p);
  return (int)cudaGetLastError();
}

}  // namespace

// cyclic_reduction: 0 = the Schur recursion, 1 = block cyclic reduction
// (SolverConfig.stage_solver == "cr").
extern "C" int admm_fused_launch(
    const float* v_ref, const float* kappa_ref, const float* delta_s,
    const float* lb_c, const float* ub_c, const float* kappa_pred,
    const float* x0, const float* W0, const float* Zw0, const float* Yeq0,
    const float* Yw0, const float* rho0, float* W, float* Zw, float* Yeq,
    float* Yw, float* rho, float* rp, float* rd, float* floor_out, int B,
    int N, int cyclic_reduction, AdmmParams p, void* stream) {
  const Outputs out{W, Zw, Yeq, Yw, rho, rp, rd};
  const auto run = cyclic_reduction ? launch<true> : launch<false>;
  return run(v_ref, kappa_ref, delta_s, lb_c, ub_c, kappa_pred, x0, W0, Zw0,
             Yeq0, Yw0, rho0, out, floor_out, B, N, p, (cudaStream_t)stream);
}
