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
// Design: one thread runs one lane (the TPU kernel's lane axis), the whole
// solve inside the thread, N a runtime argument up to NMAX.  Inputs are
// read in the public (B, N, ...) layout; nothing is transposed.
//
// What bounds it on an H100: each lane's state (stage data, 31 x 25 Schur
// inverses, iterates, the polish candidate: ~3.5k floats, ~14 KB) lives in
// local memory, and B = 4096 lanes are 128 warps, about one per SM with
// 32-thread blocks.  Every ADMM iteration is a dependent chain of ~4k
// scalar flops per lane through that local memory, so the kernel is bound
// by local-memory latency at low occupancy; device-memory traffic is one
// read of the inputs and one write of the outputs.  Later work: spread a
// lane's 5x5 stage algebra over several threads and keep factors in
// registers / shared memory.

#include "admm_core.cuh"

struct AdmmParams {  // mirrored by ctypes in ops/admm_cuda.py::_Params
  SolverParams s;
  float Q[3], QN[3], R[2], xmin[3], xmax[3];
  float v_min, v_max, ay_max, kmax;
};

namespace {

__global__ void __launch_bounds__(32) admm_fused_kernel(
    const float* __restrict__ v_ref, const float* __restrict__ kappa_ref,
    const float* __restrict__ delta_s, const float* __restrict__ lb_c,
    const float* __restrict__ ub_c, const float* __restrict__ kappa_pred,
    const float* __restrict__ x0, const float* __restrict__ W0,
    const float* __restrict__ Zw0, const float* __restrict__ Yeq0,
    const float* __restrict__ Yw0, const float* __restrict__ rho0,
    float* __restrict__ W_out, float* __restrict__ Zw_out,
    float* __restrict__ Yeq_out, float* __restrict__ Yw_out,
    float* __restrict__ rho_out, float* __restrict__ rp_out,
    float* __restrict__ rd_out, float* __restrict__ floor_out,
    int B, int N, AdmmParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int S = N + 1;
  Lane L;
  Iterate it, pol;
  L.N = N;

  const float* v = v_ref + (size_t)b * N;
  const float* k = kappa_ref + (size_t)b * N;
  const float* ds = delta_s + (size_t)b * N;
  const float* lbc = lb_c + (size_t)b * N;
  const float* ubc = ub_c + (size_t)b * N;
  const float* kp = kappa_pred + (size_t)b * N;
  const float* xb = x0 + (size_t)b * NX;
  const float inf = INFINITY;

  // ---- in-kernel assembly (the TPU kernel's _make_builder) ----
  for (int i = 0; i < NX; ++i) L.beq[0][i] = -xb[i];
  for (int n = 0; n < N; ++n) {
    const float vv = v[n], kk = k[n], dd = ds[n];
    const float row0[NW] = {1.f, dd, 0.f, 0.f, 0.f};
    const float row1[NW] = {(-(kk * kk)) * dd, 1.f, 0.f, 0.f, dd};
    const float row2[NW] = {(-(kk / vv)) * dd, 0.f, 1.f, (-dd) / (vv * vv), 0.f};
    for (int j = 0; j < NW; ++j) {
      L.AB[n][0][j] = row0[j];
      L.AB[n][1][j] = row1[j];
      L.AB[n][2][j] = row2[j];
    }
    L.beq[n + 1][0] = 0.f;
    L.beq[n + 1][1] = dd * kk;
    L.beq[n + 1][2] = (-2.0f * dd) / vv;
  }
  for (int s = 0; s < S; ++s) {
    const bool last = s == N;
    L.Pd[s][0] = last ? p.QN[0] : p.Q[0];
    L.Pd[s][1] = last ? p.QN[1] : p.Q[1];
    L.Pd[s][2] = last ? p.QN[2] : p.Q[2];
    L.Pd[s][3] = last ? 0.f : p.R[0];
    L.Pd[s][4] = last ? 0.f : p.R[1];
    float ey = 0.f;
    if (s > 0) {
      const float ctr = 0.5f * (lbc[s - 1] + ubc[s - 1]);
      ey = (last ? -p.QN[0] : -p.Q[0]) * ctr;
    }
    L.qv[s][0] = ey;
    L.qv[s][1] = 0.f;
    L.qv[s][2] = 0.f;
    L.qv[s][3] = last ? 0.f : (-p.R[0]) * v[s];
    L.qv[s][4] = last ? 0.f : (-p.R[1]) * k[s];
    L.lw[s][0] = s == 0 ? xb[0] : lbc[s - 1];
    L.uw[s][0] = s == 0 ? xb[0] : ubc[s - 1];
    L.lw[s][1] = p.xmin[1];
    L.uw[s][1] = p.xmax[1];
    L.lw[s][2] = p.xmin[2];
    L.uw[s][2] = p.xmax[2];
    if (last) {
      L.lw[s][3] = -inf; L.uw[s][3] = inf;
      L.lw[s][4] = -inf; L.uw[s][4] = inf;
    } else {
      L.lw[s][3] = p.v_min;
      L.uw[s][3] = pmin(sqrtf(p.ay_max / (fabsf(kp[s]) + 1e-12f)), p.v_max);
      L.lw[s][4] = -p.kmax;
      L.uw[s][4] = p.kmax;
    }
  }

  // ---- certified violation floor by interval reachability ----
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
    floor_out[b] = width_ok ? viol_max : 0.f;
  }

  // ---- warm start, solve, outputs (admm_core.cuh) ----
  load_warm(L, it, W0, Zw0, Yeq0, Yw0, b);
  const float rho = admm_solve(L, it, pol, p.s, rho0[b]);
  store_outputs(L, it, rho, b, W_out, Zw_out, Yeq_out, Yw_out, rho_out,
                rp_out, rd_out);
}

}  // namespace

extern "C" int admm_fused_launch(
    const float* v_ref, const float* kappa_ref, const float* delta_s,
    const float* lb_c, const float* ub_c, const float* kappa_pred,
    const float* x0, const float* W0, const float* Zw0, const float* Yeq0,
    const float* Yw0, const float* rho0, float* W, float* Zw, float* Yeq,
    float* Yw, float* rho, float* rp, float* rd, float* floor_out, int B,
    int N, AdmmParams p, void* stream) {
  if (N < 1 || N > NMAX) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  admm_fused_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      v_ref, kappa_ref, delta_s, lb_c, ub_c, kappa_pred, x0, W0, Zw0, Yeq0,
      Yw0, rho0, W, Zw, Yeq, Yw, rho, rp, rd, floor_out, B, N, p);
  return (int)cudaGetLastError();
}
