// The ADMM core shared by kernels K1 (admm_fused.cu) and K3
// (admm_structured.cu): one lane per thread, the whole solve inside the
// thread.
//
// It follows the plain PyTorch solver core multi_purpose_mpc_tpu_torch/
// ops/ltv_qp.py (admm_rounds, primal_residual, dual_residual) operation for
// operation: every sum runs left to right over the same terms, the 5x5
// inverses are Gauss-Jordan without pivoting, maxima propagate NaN like
// torch.maximum, and every file that includes this one is built with
// -fmad=false so a*b+c rounds twice as the plain version does.
//
// A kernel fills a Lane with its QP (stage layout: [A_n | B_n], beq, Pd,
// qv, lw, uw), loads the warm start with load_warm, runs admm_solve and
// writes the result with store_outputs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// Solver settings; the leading member of K1's AdmmParams, mirrored by
// ctypes in ops/admm_cuda.py (_SolverParams).
struct SolverParams {
  float sigma, alpha, one_m_alpha, eq_scale;
  int iterations, rho_updates, polish_iters;
  float polish_boost;
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
__device__ void factor(Lane& L, const SolverParams& p, float rho_eq) {
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

__device__ void iteration(Lane& L, Iterate& it, const SolverParams& p,
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
__device__ void run_iters(Lane& L, Iterate& it, const SolverParams& p,
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

// Warm start of lane b from the (B, N+1, 5|3) carry; Zw is clamped into
// the lane's bounds.
__device__ void load_warm(const Lane& L, Iterate& it, const float* W0,
                          const float* Zw0, const float* Yeq0,
                          const float* Yw0, int b) {
  const int S = L.N + 1;
  const size_t w5 = (size_t)b * S * NW, w3 = (size_t)b * S * NX;
  for (int s = 0; s < S; ++s) {
    for (int j = 0; j < NW; ++j) {
      it.W[s][j] = W0[w5 + s * NW + j];
      it.Zw[s][j] = clampf(Zw0[w5 + s * NW + j], L.lw[s][j], L.uw[s][j]);
      it.Yw[s][j] = Yw0[w5 + s * NW + j];
    }
    for (int i = 0; i < NX; ++i) it.Yeq[s][i] = Yeq0[w3 + s * NX + i];
  }
}

// The fixed-budget solve from the warm iterate `it` and step size `rho`:
// p.rho_updates adaptive-rho rounds of p.iterations iterations, then the
// guarded active-set polish (scratch iterate `pol`).  Returns the final rho.
__device__ float admm_solve(Lane& L, Iterate& it, Iterate& pol,
                            const SolverParams& p, float rho) {
  const int S = L.N + 1;
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
  return rho;
}

// Iterate, rho and residuals of lane b into the (B, N+1, 5|3) / (B,) outputs.
__device__ void store_outputs(const Lane& L, const Iterate& it, float rho,
                              int b, float* W_out, float* Zw_out,
                              float* Yeq_out, float* Yw_out, float* rho_out,
                              float* rp_out, float* rd_out) {
  const int S = L.N + 1;
  const size_t w5 = (size_t)b * S * NW, w3 = (size_t)b * S * NX;
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
