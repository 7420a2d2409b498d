// Kernel K1: fused LTV-MPC QP assembly + ADMM + violation floor.
//
// Replaces the Pallas TPU kernel multi_purpose_mpc_tpu/ops/admm_pallas.py
// (_make_kernel with build=_make_builder, entry solve_mpc_qp_fused with
// return_floor=True).  The plain PyTorch twin is
// multi_purpose_mpc_tpu_torch/ops/admm_cuda.py::solve_mpc_qp_fused_plain
// (QP assembly there, solver core in ops/ltv_qp.py); this file follows it
// operation for operation: every sum runs left to right over the same
// terms, the 5x5 inverses are Gauss-Jordan without pivoting, maxima
// propagate NaN like torch.maximum, and the file is built with
// -fmad=false so a*b+c rounds twice as the twin does.
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

#include <cuda_runtime.h>
#include <math.h>

struct AdmmParams {  // mirrored by ctypes in ops/admm_cuda.py::_Params
  float sigma, alpha, one_m_alpha, eq_scale;
  int iterations, rho_updates, polish_iters;
  float polish_boost;
  float Q[3], QN[3], R[2], xmin[3], xmax[3];
  float v_min, v_max, ay_max, kmax;
};

namespace {

constexpr int NX = 3;
constexpr int NW = 5;
constexpr int NMAX = 32;
constexpr int SMAX = NMAX + 1;

// torch.maximum / torch.minimum semantics: NaN in either operand wins.
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return pmin(pmax(x, lo), hi);
}

struct Lane {
  int N;
  float AB[NMAX][NX][NW];   // [A_n | B_n]
  float beq[SMAX][NX];
  float Pd[SMAX][NW];
  float qv[SMAX][NW];
  float lw[SMAX][NW];
  float uw[SMAX][NW];
  float Sinv[SMAX][NW][NW];
  float rho_w[SMAX][NW];
  float weq[SMAX][NX];
  float rhs[SMAX][NW];      // forward substitution runs in place here
  float Wt[SMAX][NW];       // solve output
};

struct Iterate {
  float W[SMAX][NW];
  float Zw[SMAX][NW];
  float Yeq[SMAX][NX];
  float Yw[SMAX][NW];
};

// C_n = -rho_eq [A_n | B_n]
__device__ __forceinline__ float coup(const Lane& L, float rho_eq, int n,
                                      int i, int j) {
  return -(rho_eq * L.AB[n][i][j]);
}

// (Aeq w)[s][i]: r_0 = -x_0, r_{n+1} = AB_n w_n - x_{n+1}
__device__ __forceinline__ float req(const Lane& L, const float (*W)[NW],
                                     int s, int i) {
  if (s == 0) return -W[0][i];
  const int n = s - 1;
  float acc = L.AB[n][i][0] * W[n][0];
  for (int j = 1; j < NW; ++j) acc = acc + L.AB[n][i][j] * W[n][j];
  return acc - W[s][i];
}

// (Aeq' y)[s][j] for y in equality-row space
__device__ __forceinline__ float eqT(const Lane& L, const float (*Y)[NX],
                                     int s, int j) {
  float g = 0.f;
  if (s < L.N) {
    g = L.AB[s][0][j] * Y[s + 1][0];
    g = g + L.AB[s][1][j] * Y[s + 1][1];
    g = g + L.AB[s][2][j] * Y[s + 1][2];
  }
  return j < NX ? g - Y[s][j] : g;
}

__device__ void gj_inverse(float (&a)[NW][NW], float (&inv)[NW][NW]) {
  for (int i = 0; i < NW; ++i)
    for (int j = 0; j < NW; ++j) inv[i][j] = (i == j) ? 1.f : 0.f;
  for (int k = 0; k < NW; ++k) {
    const float piv = 1.0f / a[k][k];
    for (int j = 0; j < NW; ++j) {
      a[k][j] = a[k][j] * piv;
      inv[k][j] = inv[k][j] * piv;
    }
    for (int i = 0; i < NW; ++i) {
      if (i == k) continue;
      const float f = a[i][k];
      for (int j = 0; j < NW; ++j) {
        a[i][j] = a[i][j] - f * a[k][j];
        inv[i][j] = inv[i][j] - f * inv[k][j];
      }
    }
  }
}

// Schur recursion over the block-tridiagonal reduced KKT matrix.
__device__ void factor(Lane& L, const AdmmParams& p, float rho_eq) {
  const int N = L.N;
  float S[NW][NW];
  for (int n = 0; n <= N; ++n) {
    if (n < N) {
      for (int i = 0; i < NW; ++i) {
        for (int j = 0; j < NW; ++j) {
          float ata = L.AB[n][0][i] * L.AB[n][0][j];
          ata = ata + L.AB[n][1][i] * L.AB[n][1][j];
          ata = ata + L.AB[n][2][i] * L.AB[n][2][j];
          float d = ata * rho_eq;
          if (i == j) {
            float db = (L.Pd[n][i] + p.sigma) + L.rho_w[n][i];
            if (i < NX) db = db + rho_eq;
            d = d + db;
          }
          S[i][j] = d;
        }
      }
    } else {
      for (int i = 0; i < NW; ++i)
        for (int j = 0; j < NW; ++j) S[i][j] = 0.f;
      for (int i = 0; i < NX; ++i)
        S[i][i] = ((L.Pd[N][i] + p.sigma) + L.rho_w[N][i]) + rho_eq;
      for (int i = NX; i < NW; ++i) S[i][i] = 1.f;
    }
    if (n > 0) {
      float C[NX][NW], G[NX][NW];
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NW; ++j) C[i][j] = coup(L, rho_eq, n - 1, i, j);
      for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NW; ++j) {
          float acc = C[i][0] * L.Sinv[n - 1][0][j];
          for (int k = 1; k < NW; ++k) acc = acc + C[i][k] * L.Sinv[n - 1][k][j];
          G[i][j] = acc;
        }
      }
      for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NX; ++j) {
          float acc = G[i][0] * C[j][0];
          for (int k = 1; k < NW; ++k) acc = acc + G[i][k] * C[j][k];
          S[i][j] = S[i][j] - acc;
        }
      }
    }
    gj_inverse(S, L.Sinv[n]);
  }
}

// M w = rhs: forward substitution in place on L.rhs, backward into L.Wt.
__device__ void solve(Lane& L, float rho_eq) {
  const int N = L.N;
  for (int n = 1; n <= N; ++n) {
    float Sv[NW];
    for (int i = 0; i < NW; ++i) {
      float acc = L.Sinv[n - 1][i][0] * L.rhs[n - 1][0];
      for (int j = 1; j < NW; ++j) acc = acc + L.Sinv[n - 1][i][j] * L.rhs[n - 1][j];
      Sv[i] = acc;
    }
    for (int i = 0; i < NX; ++i) {
      float acc = coup(L, rho_eq, n - 1, i, 0) * Sv[0];
      for (int j = 1; j < NW; ++j) acc = acc + coup(L, rho_eq, n - 1, i, j) * Sv[j];
      L.rhs[n][i] = L.rhs[n][i] - acc;
    }
  }
  for (int i = 0; i < NW; ++i) {
    float acc = L.Sinv[N][i][0] * L.rhs[N][0];
    for (int j = 1; j < NW; ++j) acc = acc + L.Sinv[N][i][j] * L.rhs[N][j];
    L.Wt[N][i] = acc;
  }
  for (int n = N - 1; n >= 0; --n) {
    float t[NW];
    for (int j = 0; j < NW; ++j) {
      float ctw = coup(L, rho_eq, n, 0, j) * L.Wt[n + 1][0];
      ctw = ctw + coup(L, rho_eq, n, 1, j) * L.Wt[n + 1][1];
      ctw = ctw + coup(L, rho_eq, n, 2, j) * L.Wt[n + 1][2];
      t[j] = L.rhs[n][j] - ctw;
    }
    for (int i = 0; i < NW; ++i) {
      float acc = L.Sinv[n][i][0] * t[0];
      for (int j = 1; j < NW; ++j) acc = acc + L.Sinv[n][i][j] * t[j];
      L.Wt[n][i] = acc;
    }
  }
}

__device__ void iteration(Lane& L, Iterate& it, const AdmmParams& p,
                          float rho_eq) {
  const int S = L.N + 1;
  for (int s = 0; s < S; ++s)
    for (int i = 0; i < NX; ++i)
      L.weq[s][i] = rho_eq * L.beq[s][i] - it.Yeq[s][i];
  for (int s = 0; s < S; ++s)
    for (int j = 0; j < NW; ++j)
      L.rhs[s][j] = (((p.sigma * it.W[s][j] - L.qv[s][j]) + eqT(L, L.weq, s, j))
                     + L.rho_w[s][j] * it.Zw[s][j]) - it.Yw[s][j];
  solve(L, rho_eq);
  for (int s = 0; s < S; ++s) {
    for (int i = 0; i < NX; ++i) {
      const float r = req(L, L.Wt, s, i);
      const float zpre = p.alpha * r + p.one_m_alpha * L.beq[s][i];
      it.Yeq[s][i] = it.Yeq[s][i] + rho_eq * (zpre - L.beq[s][i]);
    }
    for (int j = 0; j < NW; ++j) {
      const float wt = L.Wt[s][j];
      it.W[s][j] = p.alpha * wt + p.one_m_alpha * it.W[s][j];
      const float zp = p.alpha * wt + p.one_m_alpha * it.Zw[s][j];
      const float zn = clampf(zp + it.Yw[s][j] / L.rho_w[s][j], L.lw[s][j],
                              L.uw[s][j]);
      it.Yw[s][j] = it.Yw[s][j] + L.rho_w[s][j] * (zp - zn);
      it.Zw[s][j] = zn;
    }
  }
}

// act: per-stage bitmask of polish-boosted rows, or nullptr
__device__ void run_iters(Lane& L, Iterate& it, const AdmmParams& p,
                          int iters, float rho, const unsigned char* act) {
  const int S = L.N + 1;
  const float rho_eq = rho * p.eq_scale;
  for (int s = 0; s < S; ++s) {
    for (int j = 0; j < NW; ++j) {
      const bool is_eq = (L.uw[s][j] - L.lw[s][j]) < 1e-9f;
      float r = is_eq ? rho * p.eq_scale : rho;
      if (act) r = r * (((act[s] >> j) & 1) ? p.polish_boost : 1.0f);
      L.rho_w[s][j] = r;
    }
  }
  factor(L, p, rho_eq);
  for (int k = 0; k < iters; ++k) iteration(L, it, p, rho_eq);
}

__device__ float primal_res(const Lane& L, const float (*W)[NW]) {
  const int S = L.N + 1;
  float m1 = 0.f, m2 = 0.f;
  for (int s = 0; s < S; ++s)
    for (int i = 0; i < NX; ++i)
      m1 = pmax(m1, fabsf(req(L, W, s, i) - L.beq[s][i]));
  for (int s = 0; s < S; ++s)
    for (int j = 0; j < NW; ++j) {
      const float viol = pmax(L.lw[s][j] - W[s][j], 0.f)
                         + pmax(W[s][j] - L.uw[s][j], 0.f);
      m2 = pmax(m2, viol);
    }
  return pmax(m1, m2);
}

__device__ float dual_res(const Lane& L, const Iterate& it) {
  const int S = L.N + 1;
  float rd = 0.f;
  for (int s = 0; s < S; ++s)
    for (int j = 0; j < NW; ++j)
      rd = pmax(rd, fabsf(((L.Pd[s][j] * it.W[s][j] + L.qv[s][j])
                           + eqT(L, it.Yeq, s, j)) + it.Yw[s][j]));
  return rd;
}

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

  // ---- warm start ----
  const size_t w5 = (size_t)b * S * NW, w3 = (size_t)b * S * NX;
  for (int s = 0; s < S; ++s) {
    for (int j = 0; j < NW; ++j) {
      it.W[s][j] = W0[w5 + s * NW + j];
      it.Zw[s][j] = clampf(Zw0[w5 + s * NW + j], L.lw[s][j], L.uw[s][j]);
      it.Yw[s][j] = Yw0[w5 + s * NW + j];
    }
    for (int i = 0; i < NX; ++i) it.Yeq[s][i] = Yeq0[w3 + s * NX + i];
  }
  float rho = rho0[b];

  // ---- adaptive-rho rounds ----
  for (int round = 0; round < p.rho_updates; ++round) {
    run_iters(L, it, p, p.iterations, rho, nullptr);
    float rp_eq = 0.f, rp_w = 0.f, req_max = 0.f, w_max = 0.f;
    float rd = 0.f, pdw_max = 0.f, qv_max = 0.f, g_max = 0.f;
    for (int s = 0; s < S; ++s) {
      for (int i = 0; i < NX; ++i) {
        const float r = req(L, it.W, s, i);
        rp_eq = pmax(rp_eq, fabsf(r - L.beq[s][i]));
        req_max = pmax(req_max, fabsf(r));
      }
      for (int j = 0; j < NW; ++j) {
        const float w = it.W[s][j];
        const float g = eqT(L, it.Yeq, s, j);
        const float pw = L.Pd[s][j] * w;
        rp_w = pmax(rp_w, fabsf(w - it.Zw[s][j]));
        rd = pmax(rd, fabsf(((pw + L.qv[s][j]) + g) + it.Yw[s][j]));
        w_max = pmax(w_max, fabsf(w));
        pdw_max = pmax(pdw_max, fabsf(pw));
        qv_max = pmax(qv_max, fabsf(L.qv[s][j]));
        g_max = pmax(g_max, fabsf(g));
      }
    }
    const float rp = pmax(rp_eq, rp_w);
    const float den_p = pmax(req_max, w_max);
    const float den_d = pmax(pmax(pdw_max, qv_max), pmax(g_max, 1e-10f));
    const float ratio = sqrtf((rp / pmax(den_p, 1e-10f)) / pmax(rd / den_d, 1e-12f));
    const float rho_new = clampf(rho * ratio, 1e-6f, 1e6f);
    rho = isfinite(rho_new) ? rho_new : rho;
  }

  // ---- guarded active-set polish ----
  if (p.polish_iters > 0) {
    unsigned char act[SMAX];
    for (int s = 0; s < S; ++s) {
      unsigned char m = 0;
      for (int j = 0; j < NW; ++j) {
        const float z = it.Zw[s][j];
        const bool at_lo = z <= L.lw[s][j] + 1e-4f;
        const bool hit = at_lo || (z >= L.uw[s][j] - 1e-4f);
        if (hit && isfinite(at_lo ? L.lw[s][j] : L.uw[s][j])) m |= (1u << j);
      }
      act[s] = m;
    }
    pol = it;
    run_iters(L, pol, p, p.polish_iters, rho, act);
    if (primal_res(L, pol.W) < primal_res(L, it.W)) it = pol;
  }

  // ---- outputs ----
  for (int s = 0; s < S; ++s) {
    for (int j = 0; j < NW; ++j) {
      W_out[w5 + s * NW + j] = it.W[s][j];
      Zw_out[w5 + s * NW + j] = it.Zw[s][j];
      Yw_out[w5 + s * NW + j] = it.Yw[s][j];
    }
    for (int i = 0; i < NX; ++i) Yeq_out[w3 + s * NX + i] = it.Yeq[s][i];
  }
  rho_out[b] = rho;
  rp_out[b] = primal_res(L, it.W);
  rd_out[b] = dual_res(L, it);
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
