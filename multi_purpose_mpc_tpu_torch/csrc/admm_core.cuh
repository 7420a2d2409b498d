// The ADMM core shared by kernels K1 (admm_fused.cu) and K3
// (admm_structured.cu): one warp per lane, the lane's stages spread over
// the warp's threads, the lane's state in shared memory.
//
// It follows the plain PyTorch solver core multi_purpose_mpc_tpu_torch/
// ops/ltv_qp.py (admm_rounds, primal_residual, dual_residual) operation for
// operation: every sum runs left to right over the same terms, the 5x5
// inverses are Gauss-Jordan without pivoting, maxima propagate NaN like
// torch.maximum, and every file that includes this one is built with
// -fmad=false so a*b+c rounds twice as the plain version does.  Only who
// computes an element changes with the layout, never how.
//
// Work split inside a warp (thread t of the lane's warp):
// * stage-parallel work (assembly, the ADMM right-hand side, relaxation,
//   box projection and dual updates, the Schur diagonal blocks, residuals)
//   runs with thread t on stages t, t + 32, ...;
// * the three recurrences over the stages run in stage order: the Schur
//   factorisation on every thread of the warp at once (the same stage from
//   broadcast shared-memory reads, thread 0 storing the inverse), the
//   forward and backward substitutions one matrix row per thread, the rows
//   handed round by __shfl_sync; the stage-to-stage value stays in
//   registers;
// * per-lane scalars (the adaptive-rho ratio, the polish decision, the
//   residuals) are per-thread maxima combined by a __shfl_xor_sync
//   butterfly, so every thread of the warp takes the same decision.
//
// Max reductions: every reduced term is |x| or a sum of max(x, 0), so it is
// +0, positive, +inf or NaN, never -0.  Over such values a max tree gives
// the left-to-right result bit for bit, except that when several terms are
// NaN the NaN that comes out may carry another payload.  The tests hold
// NaN equal to NaN.
//
// Shared memory of one lane (floats; S = N + 1 stages), arrays indexed
// [stage][element] exactly as the (B, N+1, ...) tensors of the public
// layout, so warm starts, outputs and K3's QPs are copied coalesced:
//   AB [S][15], beq [S][3], Pd qv lw uw rho_w W Zw [S][5], Yeq [S][3],
//   Yw V [S][5], Vx [S][3], then 16-byte aligned C [S][16] (C_n = -rho_eq
//   [A_n|B_n], padded) and Sinv [S][28] (the 5x5 Schur inverses, padded
//   for float4 loads).  V holds the ADMM right-hand side, then the solve
//   output; Vx the x-rows of the forward substitution.  Odd strides keep
//   the per-stage accesses of the 32 threads on distinct banks.
//
// Stage solvers.  The template parameter CR of admm_solve (and of the
// functions it calls) picks how the stage system is factored and solved,
// as SolverConfig.stage_solver does in the plain version:
// * CR = false: the Schur recursion above (factor, substitute);
// * CR = true: block cyclic reduction (cr_factor, cr_solve), the plain
//   version ops/cyclic_reduction.py.  The stages are padded to
//   M = 2^k - 1 >= S with identity blocks and zero couplings; each level
//   inverts its even stages (thread t on even stages t, t + 32, ...), then
//   builds the reduced blocks and couplings of its odd stages, which form
//   the next level; a solve is the levels down, the last stage, and the
//   levels up, each level parallel over its stages.  In place of C and
//   Sinv the lane holds, per padded stage, 16-byte aligned Dinv [M][28]
//   (the block, reduced in place, then its inverse), Ol [M][16] (the
//   coupling to the left neighbour of the current level), Or [M][16] (an
//   eliminated stage's coupling to its right neighbour), X [M][5] (the
//   right-hand side, then the solution) and U [M][5] (the even stages'
//   Dinv b).  These arrays are in elimination order (cr_slot): the stages
//   one level eliminates lie side by side, so its threads read
//   neighbouring slots.

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
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SCALARS = 69;  // floats a stage from AB to Vx (layout above)
constexpr int C_STRIDE = 16;
constexpr int SINV_STRIDE = 28;
constexpr int CR_FLOATS = SINV_STRIDE + 2 * C_STRIDE + 2 * NW;  // a padded stage
// dynamic shared memory a block may take on Hopper (227 KB)
constexpr int MAX_SMEM_BYTES = 232448;
constexpr int MAX_LANES_PER_BLOCK = 4;

// CR's padded stage count M: the least 2^k - 1 >= S
// (cyclic_reduction.padded_stages).
__host__ __device__ inline int padded_stages(int S) {
  int m = 1;
  while (m < S + 1) m *= 2;
  return m - 1;
}

// Floats of shared memory per lane with S stages; mirrored by
// ops/admm_cuda.py (lane_smem_bytes), which derives N_MAX from it.
__host__ __device__ inline int lane_floats(int S, bool cr) {
  const int base = (SCALARS * S + 3) & ~3;
  return cr ? (base + CR_FLOATS * padded_stages(S) + 3) & ~3
            : base + (C_STRIDE + SINV_STRIDE) * S;
}

// Lanes per block at horizon N (0: the lane does not fit).
inline int lanes_per_block(int N, bool cr) {
  const int bytes = lane_floats(N + 1, cr) * 4;
  const int fit = MAX_SMEM_BYTES / bytes;
  return fit < MAX_LANES_PER_BLOCK ? fit : MAX_LANES_PER_BLOCK;
}

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1)
    v = pmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// One lane's shared-memory arrays and the thread's place in its warp
// (C, Sinv: the Schur recursion; M, Dinv .. U: cyclic reduction).
struct Lane {
  int N, S, t, M;
  float *AB, *beq, *Pd, *qv, *lw, *uw, *rho_w, *W, *Zw, *Yeq, *Yw, *V, *Vx,
      *C, *Sinv, *Dinv, *Ol, *Or, *X, *U;
};

// The lane of warp `w` in the block's dynamic shared memory.
template <bool CR>
__device__ __forceinline__ Lane lane_at(float* smem, int w, int N) {
  const int S = N + 1;
  Lane L;
  L.N = N;
  L.S = S;
  L.t = threadIdx.x & (WARP - 1);
  L.M = padded_stages(S);
  float* p = smem + (size_t)w * lane_floats(S, CR);
  L.AB = p;      p += 15 * S;
  L.beq = p;     p += NX * S;
  L.Pd = p;      p += NW * S;
  L.qv = p;      p += NW * S;
  L.lw = p;      p += NW * S;
  L.uw = p;      p += NW * S;
  L.rho_w = p;   p += NW * S;
  L.W = p;       p += NW * S;
  L.Zw = p;      p += NW * S;
  L.Yeq = p;     p += NX * S;
  L.Yw = p;      p += NW * S;
  L.V = p;       p += NW * S;
  L.Vx = p;
  p = smem + (size_t)w * lane_floats(S, CR) + ((SCALARS * S + 3) & ~3);
  if (CR) {
    L.C = L.Sinv = nullptr;
    L.Dinv = p;  p += SINV_STRIDE * L.M;
    L.Ol = p;    p += C_STRIDE * L.M;
    L.Or = p;    p += C_STRIDE * L.M;
    L.X = p;     p += NW * L.M;
    L.U = p;
  } else {
    L.C = p;     p += C_STRIDE * S;
    L.Sinv = p;
    L.Dinv = L.Ol = L.Or = L.X = L.U = nullptr;
  }
  return L;
}

// Slot of padded stage i in CR's arrays: elimination order.  Stage i is
// eliminated at level l = the number of trailing one bits of i, as even
// stage u = (i + 1) >> (l + 1) of that level; the levels before l
// eliminated (M + 1) - ((M + 1) >> l) stages.  M1 = M + 1.  The last
// stage, (M - 1) / 2, takes slot M - 1.
__device__ __forceinline__ int cr_slot(int M1, int i) {
  const int v = i + 1;
  const int l = __ffs(v) - 1;
  return (M1 - (M1 >> l)) + (v >> (l + 1));
}

// (Aeq w)[s][i] of the stage-layout vector W: r_0 = -x_0,
// r_{n+1} = AB_n w_n - x_{n+1}
__device__ __forceinline__ float req(const Lane& L, const float* W, int s,
                                     int i) {
  if (s == 0) return -W[i];
  const float* ab = L.AB + (s - 1) * 15 + i * NW;
  const float* w = W + (s - 1) * NW;
  float acc = ab[0] * w[0];
#pragma unroll
  for (int j = 1; j < NW; ++j) acc = acc + ab[j] * w[j];
  return acc - W[s * NW + i];
}

// (Aeq' y)[s][j] for y in equality-row space: yn = y[s+1] (unused at
// s = N), ys = y[s]
__device__ __forceinline__ float eqT(const Lane& L, const float* yn,
                                     const float* ys, int s, int j) {
  float g = 0.f;
  if (s < L.N) {
    const float* ab = L.AB + s * 15;
    g = ab[j] * yn[0];
    g = g + ab[NW + j] * yn[1];
    g = g + ab[2 * NW + j] * yn[2];
  }
  return j < NX ? g - ys[j] : g;
}

__device__ __forceinline__ void gj_inverse(float (&a)[NW][NW],
                                           float (&inv)[NW][NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) inv[i][j] = (i == j) ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const float piv = 1.0f / a[k][k];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      a[k][j] = a[k][j] * piv;
      inv[k][j] = inv[k][j] * piv;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (i == k) continue;
      const float f = a[i][k];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        a[i][j] = a[i][j] - f * a[k][j];
        inv[i][j] = inv[i][j] - f * inv[k][j];
      }
    }
  }
}

__device__ __forceinline__ void load25(const float* p, float (&m)[NW][NW]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  float v[SINV_STRIDE];
#pragma unroll
  for (int k = 0; k < SINV_STRIDE / 4; ++k) {
    const float4 x = q[k];
    v[4 * k] = x.x; v[4 * k + 1] = x.y; v[4 * k + 2] = x.z; v[4 * k + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) m[i][j] = v[i * NW + j];
}

__device__ __forceinline__ void load15(const float* p, float (&m)[NX][NW]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  float v[C_STRIDE];
#pragma unroll
  for (int k = 0; k < C_STRIDE / 4; ++k) {
    const float4 x = q[k];
    v[4 * k] = x.x; v[4 * k + 1] = x.y; v[4 * k + 2] = x.z; v[4 * k + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) m[i][j] = v[i * NW + j];
}

__device__ __forceinline__ void store25(float* p, const float (&m)[NW][NW]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < 6; ++k)
    q[k] = make_float4(m[(4 * k) / NW][(4 * k) % NW],
                       m[(4 * k + 1) / NW][(4 * k + 1) % NW],
                       m[(4 * k + 2) / NW][(4 * k + 2) % NW],
                       m[(4 * k + 3) / NW][(4 * k + 3) % NW]);
  p[24] = m[4][4];
}

__device__ __forceinline__ void store15(float* p, const float (&m)[NX][NW]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    q[k] = make_float4(m[(4 * k) / NW][(4 * k) % NW],
                       m[(4 * k + 1) / NW][(4 * k + 1) % NW],
                       m[(4 * k + 2) / NW][(4 * k + 2) % NW],
                       m[(4 * k + 3) / NW][(4 * k + 3) % NW]);
  p[12] = m[2][2];
  p[13] = m[2][3];
  p[14] = m[2][4];
}

// Step sizes, couplings C_n and the diagonal blocks of one factor
// (stage-parallel).  Schur: D_n into Sinv's slot n, C_n into C's.  CR: D_n
// into Dinv's slot of stage n, C_n into Ol's slot of stage n + 1 (the
// coupling of stage n + 1 to stage n), identity blocks and zero couplings
// on the pad stages.  polish: boost the rows whose Zw sits at a finite
// bound.
template <bool CR>
__device__ __forceinline__ void prepare_factor(const Lane& L,
                                               const SolverParams& p,
                                               float rho, bool polish) {
  const int N = L.N;
  const float rho_eq = rho * p.eq_scale;
  for (int s = L.t; s < L.S; s += WARP) {
    float rw[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const float lo = L.lw[s * NW + j], hi = L.uw[s * NW + j];
      const bool is_eq = (hi - lo) < 1e-9f;
      float r = is_eq ? rho * p.eq_scale : rho;
      if (polish) {
        const float z = L.Zw[s * NW + j];
        const bool at_lo = z <= lo + 1e-4f;
        const bool hit = at_lo || (z >= hi - 1e-4f);
        const bool act = hit && isfinite(at_lo ? lo : hi);
        r = r * (act ? p.polish_boost : 1.0f);
      }
      rw[j] = r;
      L.rho_w[s * NW + j] = r;
    }
    float* D = CR ? L.Dinv + cr_slot(L.M + 1, s) * SINV_STRIDE
                  : L.Sinv + s * SINV_STRIDE;
    if (s < N) {
      const float* ab = L.AB + s * 15;
      float* c = CR ? L.Ol + cr_slot(L.M + 1, s + 1) * C_STRIDE
                    : L.C + s * C_STRIDE;
#pragma unroll
      for (int e = 0; e < 15; ++e) c[e] = -(rho_eq * ab[e]);
#pragma unroll
      for (int i = 0; i < NW; ++i) {
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          float ata = ab[i] * ab[j];
          ata = ata + ab[NW + i] * ab[NW + j];
          ata = ata + ab[2 * NW + i] * ab[2 * NW + j];
          float d = ata * rho_eq;
          if (i == j) {
            float db = (L.Pd[s * NW + i] + p.sigma) + rw[i];
            if (i < NX) db = db + rho_eq;
            d = d + db;
          }
          D[i * NW + j] = d;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j) D[i * NW + j] = 0.f;
#pragma unroll
      for (int i = 0; i < NX; ++i)
        D[i * NW + i] = ((L.Pd[s * NW + i] + p.sigma) + rw[i]) + rho_eq;
#pragma unroll
      for (int i = NX; i < NW; ++i) D[i * NW + i] = 1.f;
    }
  }
  if (CR) {
    for (int s = L.S + L.t; s < L.M; s += WARP) {
      const int k = cr_slot(L.M + 1, s);
#pragma unroll
      for (int e = 0; e < NW * NW; ++e)
        L.Dinv[k * SINV_STRIDE + e] = (e % (NW + 1) == 0) ? 1.f : 0.f;
#pragma unroll
      for (int e = 0; e < NX * NW; ++e) L.Ol[k * C_STRIDE + e] = 0.f;
    }
  }
  __syncwarp();
}

// Schur recursion S_0 = D_0, S_n = D_n - C_{n-1} S_{n-1}^-1 C_{n-1}'
// (x-x block), in stage order; Sinv_{n-1} is carried in registers.
__device__ __forceinline__ void factor(const Lane& L) {
  float prev[NW][NW];
  for (int n = 0; n <= L.N; ++n) {
    float a[NW][NW], inv[NW][NW];
    load25(L.Sinv + n * SINV_STRIDE, a);
    if (n > 0) {
      float C[NX][NW], G[NX][NW];
      load15(L.C + (n - 1) * C_STRIDE, C);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          float acc = C[i][0] * prev[0][j];
#pragma unroll
          for (int k = 1; k < NW; ++k) acc = acc + C[i][k] * prev[k][j];
          G[i][j] = acc;
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float acc = G[i][0] * C[j][0];
#pragma unroll
          for (int k = 1; k < NW; ++k) acc = acc + G[i][k] * C[j][k];
          a[i][j] = a[i][j] - acc;
        }
      }
    }
    gj_inverse(a, inv);
    __syncwarp();  // every thread has read slot n before thread 0 rewrites it
    if (L.t == 0) {
      float* out = L.Sinv + n * SINV_STRIDE;
#pragma unroll
      for (int i = 0; i < NW; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j) out[i * NW + j] = inv[i][j];
    }
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j) prev[i][j] = inv[i][j];
  }
  __syncwarp();
}

// M w = V in stage order.  Each stage step's matrix-vector products run
// one row per thread (thread t < 5 computes row t; the others repeat rows
// t % 5 and their results go unused), and __shfl_sync hands the rows to
// every thread.  Forward: v_0 = V_0, v_n = V_n - pad(C_{n-1} Sinv_{n-1}
// v_{n-1}), the x-rows of v_n kept in Vx; backward: w_N = Sinv_N v_N,
// w_n = Sinv_n (v_n - C_n' w_{n+1}[x]) into V.  Thread t < 5 is the only
// one to read or write element t of V and Vx during the backward pass.
__device__ __forceinline__ void substitute(const Lane& L) {
  const int N = L.N;
  const int r = L.t % NW;  // the row this thread computes
  const bool owner = L.t < NW;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  float v[NW];
  for (int n = 0;; ++n) {
#pragma unroll
    for (int i = 0; i < NW; ++i) v[i] = L.V[n * NW + i];
    if (n > 0) {
      v[0] = v[0] - g0;
      v[1] = v[1] - g1;
      v[2] = v[2] - g2;
    }
    if (L.t < NX) L.Vx[n * NX + L.t] = L.t == 0 ? v[0] : L.t == 1 ? v[1] : v[2];
    if (n == N) break;
    const float* srow = L.Sinv + n * SINV_STRIDE + r * NW;
    float acc = srow[0] * v[0];
#pragma unroll
    for (int j = 1; j < NW; ++j) acc = acc + srow[j] * v[j];
    float Sv[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) Sv[j] = __shfl_sync(FULL, acc, j);
    const float* crow = L.C + n * C_STRIDE + (r < NX ? r : 0) * NW;
    float gacc = crow[0] * Sv[0];
#pragma unroll
    for (int j = 1; j < NW; ++j) gacc = gacc + crow[j] * Sv[j];
    g0 = __shfl_sync(FULL, gacc, 0);
    g1 = __shfl_sync(FULL, gacc, 1);
    g2 = __shfl_sync(FULL, gacc, 2);
  }
  __syncwarp();  // the forward reads of V are done before V is rewritten
  float w;
  {
    const float* srow = L.Sinv + N * SINV_STRIDE + r * NW;
    w = srow[0] * v[0];
#pragma unroll
    for (int j = 1; j < NW; ++j) w = w + srow[j] * v[j];
  }
  if (owner) L.V[N * NW + L.t] = w;
  float w0 = __shfl_sync(FULL, w, 0);
  float w1 = __shfl_sync(FULL, w, 1);
  float w2 = __shfl_sync(FULL, w, 2);
  for (int n = N - 1; n >= 0; --n) {
    const float* c = L.C + n * C_STRIDE;
    float ctw = c[r] * w0;
    ctw = ctw + c[NW + r] * w1;
    ctw = ctw + c[2 * NW + r] * w2;
    float vn = 0.f;
    if (owner) vn = r < NX ? L.Vx[n * NX + r] : L.V[n * NW + r];
    const float tr = vn - ctw;
    float tv[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) tv[j] = __shfl_sync(FULL, tr, j);
    const float* srow = L.Sinv + n * SINV_STRIDE + r * NW;
    w = srow[0] * tv[0];
#pragma unroll
    for (int j = 1; j < NW; ++j) w = w + srow[j] * tv[j];
    if (owner) L.V[n * NW + L.t] = w;
    w0 = __shfl_sync(FULL, w, 0);
    w1 = __shfl_sync(FULL, w, 1);
    w2 = __shfl_sync(FULL, w, 2);
  }
  __syncwarp();
}

// ---- block cyclic reduction (CR = true) ----
//
// Level l holds mc = ((M + 1) >> l) - 1 stages: e = (M + 1) >> (l + 1)
// even ones, in slots off .. off + e - 1 (off = (M + 1) - ((M + 1) >> l)),
// and mp = e - 1 odd ones; odd stage u is padded stage
// ((u + 1) << (l + 1)) - 1, between even stages u and u + 1.  Every product
// sums its terms in the plain version's order (ops/cyclic_reduction.py),
// and skips only terms that the plain version adds as +0 (x - 0 = x bit
// for bit, NaN and -0 included).

// Factor: per level, invert the even stages' blocks in place; then each
// odd stage u, with OL = its coupling to even stage u, OR = even stage
// u + 1's coupling to it, and Dinv_u, Dinv_u+1:
//   D' = (D - OL Dinv_u OL' [x-x block]) - OR' Dinv_u+1[x, x] OR,
//   O' = -(OL Dinv_u[:, x] OR_prev)   (OR_prev: even stage u's left
// coupling; u = 0 has no left neighbour and its O' is never read),
// keeping OL in even stage u's Or slot for the solve.
__device__ __forceinline__ void cr_factor(const Lane& L) {
  const int M1 = L.M + 1;
  for (int l = 0; (M1 >> l) > 2; ++l) {
    const int e = M1 >> (l + 1), mp = e - 1, off = M1 - (M1 >> l);
    for (int u = L.t; u < e; u += WARP) {
      float a[NW][NW], inv[NW][NW];
      float* d = L.Dinv + (off + u) * SINV_STRIDE;
      load25(d, a);
      gj_inverse(a, inv);
      store25(d, inv);
    }
    __syncwarp();
    for (int u = L.t; u < mp; u += WARP) {
      // the reduced block is updated in place in shared memory (a float
      // stored and reloaded rounds nothing), which keeps the registers of
      // this step to one 3x5 coupling and one partial product
      const int q = cr_slot(M1, ((u + 1) << (l + 1)) - 1);
      const float* di0 = L.Dinv + (off + u) * SINV_STRIDE;
      const float* di1 = di0 + SINV_STRIDE;
      float* D = L.Dinv + q * SINV_STRIDE;
      float OL[NX][NW];
      load15(L.Ol + q * C_STRIDE, OL);
      store15(L.Or + (off + u) * C_STRIDE, OL);
      {  // D[x, x] -= OL (Dinv_u OL')
        float X[NW][NX];
#pragma unroll
        for (int i = 0; i < NW; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float acc = di0[i * NW] * OL[j][0];
#pragma unroll
            for (int k = 1; k < NW; ++k) acc = acc + di0[i * NW + k] * OL[j][k];
            X[i][j] = acc;
          }
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float acc = OL[i][0] * X[0][j];
#pragma unroll
            for (int k = 1; k < NW; ++k) acc = acc + OL[i][k] * X[k][j];
            D[i * NW + j] = D[i * NW + j] - acc;
          }
      }
      {  // D -= OR' (Dinv_u+1[x, x] OR)
        float OR[NX][NW], Y[NX][NW];
        load15(L.Ol + (off + u + 1) * C_STRIDE, OR);
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            float acc = di1[i * NW] * OR[0][j];
#pragma unroll
            for (int k = 1; k < NX; ++k) acc = acc + di1[i * NW + k] * OR[k][j];
            Y[i][j] = acc;
          }
#pragma unroll
        for (int i = 0; i < NW; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            float acc = OR[0][i] * Y[0][j];
#pragma unroll
            for (int k = 1; k < NX; ++k) acc = acc + OR[k][i] * Y[k][j];
            D[i * NW + j] = D[i * NW + j] - acc;
          }
      }
      if (u > 0) {  // O' = -(OL (Dinv_u[:, x] OR_prev)), column by column
        float ORp[NX][NW], O[NX][NW];
        load15(L.Ol + (off + u) * C_STRIDE, ORp);
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          float z[NW];
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            float acc = di0[i * NW] * ORp[0][j];
#pragma unroll
            for (int k = 1; k < NX; ++k) acc = acc + di0[i * NW + k] * ORp[k][j];
            z[i] = acc;
          }
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            float acc = OL[i][0] * z[0];
#pragma unroll
            for (int k = 1; k < NW; ++k) acc = acc + OL[i][k] * z[k];
            O[i][j] = -acc;
          }
        }
        store15(L.Ol + q * C_STRIDE, O);
      }
    }
    __syncwarp();
  }
  if (L.t == 0) {  // the last level's one stage
    float a[NW][NW], inv[NW][NW];
    float* d = L.Dinv + (L.M - 1) * SINV_STRIDE;
    load25(d, a);
    gj_inverse(a, inv);
    store25(d, inv);
  }
  __syncwarp();
}

// w = Dinv b for the 5x5 inverse at `di` (left-to-right sums)
__device__ __forceinline__ void cr_mv(const float* di, const float (&b)[NW],
                                      float (&w)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    float acc = di[i * NW] * b[0];
#pragma unroll
    for (int j = 1; j < NW; ++j) acc = acc + di[i * NW + j] * b[j];
    w[i] = acc;
  }
}

// M w = V.  Down: per level, U_u = Dinv_u X_u on the even stages, then
// each odd stage X -= pad(OL U_u) and X -= OR' U_u+1[x]; the last stage
// X = Dinv X; up: per level, each even stage X_u = Dinv_u ((X_u -
// pad(OR_prev w_left)) - OL_u' w_right[x]), the odd neighbours solved.
__device__ __forceinline__ void cr_solve(const Lane& L) {
  const int M1 = L.M + 1;
  for (int s = L.t; s < L.M; s += WARP) {
    float* x = L.X + cr_slot(M1, s) * NW;
#pragma unroll
    for (int j = 0; j < NW; ++j) x[j] = s < L.S ? L.V[s * NW + j] : 0.f;
  }
  __syncwarp();
  int l = 0;
  for (; (M1 >> l) > 2; ++l) {
    const int e = M1 >> (l + 1), mp = e - 1, off = M1 - (M1 >> l);
    for (int u = L.t; u < e; u += WARP) {
      const int k = off + u;
      float b[NW], w[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) b[j] = L.X[k * NW + j];
      cr_mv(L.Dinv + k * SINV_STRIDE, b, w);
#pragma unroll
      for (int j = 0; j < NW; ++j) L.U[k * NW + j] = w[j];
    }
    __syncwarp();
    for (int u = L.t; u < mp; u += WARP) {
      const int q = cr_slot(M1, ((u + 1) << (l + 1)) - 1);
      const float* OL = L.Or + (off + u) * C_STRIDE;
      const float* OR = L.Ol + (off + u + 1) * C_STRIDE;
      const float* u0 = L.U + (off + u) * NW;
      const float* u1 = u0 + NW;
      float* x = L.X + q * NW;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = OL[i * NW] * u0[0];
#pragma unroll
        for (int j = 1; j < NW; ++j) acc = acc + OL[i * NW + j] * u0[j];
        x[i] = x[i] - acc;
      }
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        float acc = OR[j] * u1[0];
        acc = acc + OR[NW + j] * u1[1];
        acc = acc + OR[2 * NW + j] * u1[2];
        x[j] = x[j] - acc;
      }
    }
    __syncwarp();
  }
  if (L.t == 0) {
    float b[NW], w[NW];
    float* x = L.X + (L.M - 1) * NW;
#pragma unroll
    for (int j = 0; j < NW; ++j) b[j] = x[j];
    cr_mv(L.Dinv + (L.M - 1) * SINV_STRIDE, b, w);
#pragma unroll
    for (int j = 0; j < NW; ++j) x[j] = w[j];
  }
  __syncwarp();
  for (--l; l >= 0; --l) {
    const int e = M1 >> (l + 1), mp = e - 1, off = M1 - (M1 >> l);
    for (int u = L.t; u < e; u += WARP) {
      const int k = off + u;
      float b[NW], w[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) b[j] = L.X[k * NW + j];
      if (u > 0) {  // the odd neighbour on the left
        const float* O = L.Ol + k * C_STRIDE;
        const float* wl = L.X + cr_slot(M1, (u << (l + 1)) - 1) * NW;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          float acc = O[i * NW] * wl[0];
#pragma unroll
          for (int j = 1; j < NW; ++j) acc = acc + O[i * NW + j] * wl[j];
          b[i] = b[i] - acc;
        }
      }
      if (u < mp) {  // the odd neighbour on the right
        const float* O = L.Or + k * C_STRIDE;
        const float* wr = L.X + cr_slot(M1, ((u + 1) << (l + 1)) - 1) * NW;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          float acc = O[j] * wr[0];
          acc = acc + O[NW + j] * wr[1];
          acc = acc + O[2 * NW + j] * wr[2];
          b[j] = b[j] - acc;
        }
      }
      cr_mv(L.Dinv + k * SINV_STRIDE, b, w);
#pragma unroll
      for (int j = 0; j < NW; ++j) L.X[k * NW + j] = w[j];
    }
    __syncwarp();
  }
  for (int s = L.t; s < L.S; s += WARP) {
    const float* x = L.X + cr_slot(M1, s) * NW;
#pragma unroll
    for (int j = 0; j < NW; ++j) L.V[s * NW + j] = x[j];
  }
  __syncwarp();
}

template <bool CR>
__device__ __forceinline__ void iteration(const Lane& L,
                                          const SolverParams& p,
                                          float rho_eq) {
  // right-hand side, stage-parallel (weq = rho_eq beq - Yeq)
  for (int s = L.t; s < L.S; s += WARP) {
    float ws[NX], wn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ws[i] = rho_eq * L.beq[s * NX + i] - L.Yeq[s * NX + i];
      wn[i] = s < L.N
          ? rho_eq * L.beq[(s + 1) * NX + i] - L.Yeq[(s + 1) * NX + i]
          : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int e = s * NW + j;
      L.V[e] = (((p.sigma * L.W[e] - L.qv[e]) + eqT(L, wn, ws, s, j))
                + L.rho_w[e] * L.Zw[e]) - L.Yw[e];
    }
  }
  __syncwarp();
  if constexpr (CR)
    cr_solve(L);
  else
    substitute(L);
  // relaxation, projection and dual updates, stage-parallel
  for (int s = L.t; s < L.S; s += WARP) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float b = L.beq[s * NX + i];
      const float r = req(L, L.V, s, i);
      const float zpre = p.alpha * r + p.one_m_alpha * b;
      L.Yeq[s * NX + i] = L.Yeq[s * NX + i] + rho_eq * (zpre - b);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int e = s * NW + j;
      const float wt = L.V[e], rw = L.rho_w[e], yw = L.Yw[e];
      L.W[e] = p.alpha * wt + p.one_m_alpha * L.W[e];
      const float zp = p.alpha * wt + p.one_m_alpha * L.Zw[e];
      const float zn = clampf(zp + yw / rw, L.lw[e], L.uw[e]);
      L.Yw[e] = yw + rw * (zp - zn);
      L.Zw[e] = zn;
    }
  }
  __syncwarp();
}

template <bool CR>
__device__ __forceinline__ void run_iters(const Lane& L,
                                          const SolverParams& p, int iters,
                                          float rho, bool polish) {
  prepare_factor<CR>(L, p, rho, polish);
  if constexpr (CR)
    cr_factor(L);
  else
    factor(L);
  const float rho_eq = rho * p.eq_scale;
  for (int k = 0; k < iters; ++k) iteration<CR>(L, p, rho_eq);
}

__device__ __forceinline__ float primal_res(const Lane& L) {
  float m1 = 0.f, m2 = 0.f;
  for (int s = L.t; s < L.S; s += WARP) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
      m1 = pmax(m1, fabsf(req(L, L.W, s, i) - L.beq[s * NX + i]));
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int e = s * NW + j;
      const float viol = pmax(L.lw[e] - L.W[e], 0.f)
                         + pmax(L.W[e] - L.uw[e], 0.f);
      m2 = pmax(m2, viol);
    }
  }
  return pmax(warp_max(m1), warp_max(m2));
}

__device__ __forceinline__ float dual_res(const Lane& L) {
  float rd = 0.f;
  for (int s = L.t; s < L.S; s += WARP) {
    const float* yn = s < L.N ? L.Yeq + (s + 1) * NX : L.Yeq;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int e = s * NW + j;
      rd = pmax(rd, fabsf(((L.Pd[e] * L.W[e] + L.qv[e])
                           + eqT(L, yn, L.Yeq + s * NX, s, j)) + L.Yw[e]));
    }
  }
  return warp_max(rd);
}

// One adaptive-rho update from the current iterate.
__device__ __forceinline__ float adapt_rho(const Lane& L, float rho) {
  float rp_eq = 0.f, rp_w = 0.f, req_max = 0.f, w_max = 0.f;
  float rd = 0.f, pdw_max = 0.f, qv_max = 0.f, g_max = 0.f;
  for (int s = L.t; s < L.S; s += WARP) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float r = req(L, L.W, s, i);
      rp_eq = pmax(rp_eq, fabsf(r - L.beq[s * NX + i]));
      req_max = pmax(req_max, fabsf(r));
    }
    const float* yn = s < L.N ? L.Yeq + (s + 1) * NX : L.Yeq;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int e = s * NW + j;
      const float w = L.W[e];
      const float g = eqT(L, yn, L.Yeq + s * NX, s, j);
      const float pw = L.Pd[e] * w;
      rp_w = pmax(rp_w, fabsf(w - L.Zw[e]));
      rd = pmax(rd, fabsf(((pw + L.qv[e]) + g) + L.Yw[e]));
      w_max = pmax(w_max, fabsf(w));
      pdw_max = pmax(pdw_max, fabsf(pw));
      qv_max = pmax(qv_max, fabsf(L.qv[e]));
      g_max = pmax(g_max, fabsf(g));
    }
  }
  rp_eq = warp_max(rp_eq);
  rp_w = warp_max(rp_w);
  req_max = warp_max(req_max);
  w_max = warp_max(w_max);
  rd = warp_max(rd);
  pdw_max = warp_max(pdw_max);
  qv_max = warp_max(qv_max);
  g_max = warp_max(g_max);
  const float rp = pmax(rp_eq, rp_w);
  const float den_p = pmax(req_max, w_max);
  const float den_d = pmax(pmax(pdw_max, qv_max), pmax(g_max, 1e-10f));
  const float ratio = sqrtf((rp / pmax(den_p, 1e-10f)) / pmax(rd / den_d, 1e-12f));
  const float rho_new = clampf(rho * ratio, 1e-6f, 1e6f);
  return isfinite(rho_new) ? rho_new : rho;
}

// Output pointers of a solve: (B, N+1, 5|3) iterates, (B,) scalars.
struct Outputs {
  float *W, *Zw, *Yeq, *Yw, *rho, *rp, *rd;
};

// Warm start of lane b from the (B, N+1, 5|3) carry, coalesced; Zw is
// clamped into the lane's bounds (lw, uw must be in place).
__device__ __forceinline__ void load_warm(const Lane& L, const float* W0,
                                          const float* Zw0, const float* Yeq0,
                                          const float* Yw0, int b) {
  const size_t w5 = (size_t)b * L.S * NW, w3 = (size_t)b * L.S * NX;
  for (int e = L.t; e < L.S * NW; e += WARP) {
    L.W[e] = W0[w5 + e];
    L.Zw[e] = clampf(Zw0[w5 + e], L.lw[e], L.uw[e]);
    L.Yw[e] = Yw0[w5 + e];
  }
  for (int e = L.t; e < L.S * NX; e += WARP) L.Yeq[e] = Yeq0[w3 + e];
  __syncwarp();
}

__device__ __forceinline__ void store_iterate(const Lane& L,
                                              const Outputs& o, int b) {
  const size_t w5 = (size_t)b * L.S * NW, w3 = (size_t)b * L.S * NX;
  for (int e = L.t; e < L.S * NW; e += WARP) {
    o.W[w5 + e] = L.W[e];
    o.Zw[w5 + e] = L.Zw[e];
    o.Yw[w5 + e] = L.Yw[e];
  }
  for (int e = L.t; e < L.S * NX; e += WARP) o.Yeq[w3 + e] = L.Yeq[e];
}

// The fixed-budget solve of lane b from the warm iterate in L and step
// size `rho`: p.rho_updates adaptive-rho rounds of p.iterations
// iterations, then the guarded active-set polish; writes the iterate, rho
// and the residuals.  The pre-polish iterate is written to the outputs
// first and overwritten only if the polish lowers the primal residual, so
// the lane needs no second copy of its state.  CR: the stage solver.
template <bool CR>
__device__ __forceinline__ void admm_solve(const Lane& L,
                                           const SolverParams& p, float rho,
                                           const Outputs& o, int b) {
  for (int round = 0; round < p.rho_updates; ++round) {
    run_iters<CR>(L, p, p.iterations, rho, false);
    rho = adapt_rho(L, rho);
  }
  store_iterate(L, o, b);
  float rp = primal_res(L), rd = dual_res(L);
  if (p.polish_iters > 0) {
    run_iters<CR>(L, p, p.polish_iters, rho, true);
    const float rp_pol = primal_res(L);
    if (rp_pol < rp) {  // warp-uniform: every thread holds the same maxima
      store_iterate(L, o, b);
      rp = rp_pol;
      rd = dual_res(L);
    }
  }
  if (L.t == 0) {
    o.rho[b] = rho;
    o.rp[b] = rp;
    o.rd[b] = rd;
  }
}

}  // namespace
