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
// * the Schur factorisation runs in stage order on every thread of the
//   warp at once (the same stage from broadcast shared-memory reads,
//   thread 0 storing the inverse Sinv_n and G_{n-1} = C_{n-1} Sinv_{n-1}):
//   the block LDL' factors of the stage system;
// * a stage solve (substitute) is the block LDL' solve: its two sequential
//   chains carry only the 3 x-rows of a stage, in thread 0's registers,
//   with no shuffle and no shared-memory round trip on the chain (the next
//   stage's operands are loaded before this stage's store); the u-rows'
//   terms and the diagonal solves z_n = Sinv_n y_n are stage-parallel
//   passes around the chains;
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
//   Yw V [S][5], then 16-byte aligned Gx [S][8] and Gr [S][7] (the factor's
//   G_n = C_n Sinv_n, 3x5: Gx its x-x block but G_n[2][2], for the chains'
//   float4 loads; Gr G_n[2][2] and the u-columns, gr_at) and Sinv [S][28]
//   (the 5x5 Schur inverses, padded for float4 loads).  V holds the ADMM
//   right-hand side, then y and z of the solve in place, then its output
//   w.  Odd strides keep the per-stage accesses of the 32 threads on
//   distinct banks.
//
// Stage solvers.  The template parameter CR of admm_solve (and of the
// functions it calls) picks how the stage system is factored and solved,
// as SolverConfig.stage_solver does in the plain version:
// * CR = false: the Schur recursion above (factor, substitute);
// * CR = true: block cyclic reduction (cr_factor, cr_solve), the plain
//   version ops/cyclic_reduction.py.  The stages are padded to
//   M = 2^k - 1 >= S with identity blocks and zero couplings; each level
//   inverts its even stages, then builds the reduced blocks and couplings
//   of its odd stages, which form the next level; a solve is the levels
//   down, the last stage, and the levels up.
//
// CR layout.  The lane keeps the first 61 floats a stage of the Schur
// layout (AB .. Yw; no V), then, per padded stage in elimination
// order (cr_slot: the stages one level eliminates lie side by side),
// Dinv [M][25] (the block, reduced in place, then its inverse) and X [M][5]
// (the ADMM right-hand side, written there by the iteration, then the
// solution, read from there), then the couplings once per odd stage of
// every level (P = M - log2(M + 1) of them, level l's from pair off_l - l,
// off_l its first slot): OL [P][15] (the odd stage's coupling to its left
// even neighbour, 3x5 row-major) and ORt [P][15] (the right even
// neighbour's coupling to it, stored transposed, 5x3).  The factor writes
// each odd stage's reduced coupling straight into the next level's pair,
// so no coupling is copied or kept twice.  Strides 25, 15 and 5 are odd:
// the scalar reads of the solve fall on distinct banks.
//
// CR work split.  Stage-parallel work as for Schur.  The factor gives one
// thread a stage (the inverses and the odd stages' reductions, ~7 times a
// solve).  The solve (~190 times a solve) spreads each level over the
// warp.  A level of CR_WIDE or more even stages gives a thread a stage
// (its five row sums independent, their latencies overlapped): down, a
// round takes 32 even and 31 odd stages, U = Dinv x in registers and U_u+1
// from the next thread by __shfl_down_sync; up, a thread solves its even
// stage.  A narrower level gives a thread a (stage, row) pair: thread t is
// row r = t % 5 of group g = t / 5 (6 groups, threads 30-31 idle); down, a
// round takes even stages base .. base + 5 (one a group) and odd stages
// base .. base + 4, each odd row taking the U rows it needs from its group
// and the next by __shfl_sync, and the last level's odd stage, the last
// stage, is solved in the same round; up, a round takes 6 even stages,
// the rows of b handed round the group, then a row of Dinv b written over
// the thread's own element of x.  U never reaches shared memory, and a
// level needs one __syncwarp.

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
constexpr int SCALARS = 66;  // floats a stage from AB to V (layout above)
constexpr int GX_STRIDE = 8;  // G_n[0][0..2], G_n[1][0]; G_n[1][1..2], G_n[2][0..1]
constexpr int GR_STRIDE = 7;  // G_n[2][2], then G_n[i][3], G_n[i][4] (gr_at)
constexpr int SINV_STRIDE = 28;
// CR: floats a stage from AB to Yw, and the strides of Dinv and of one
// coupling (layout above)
constexpr int CR_SCALARS = 61;
constexpr int DINV_STRIDE = 25;
constexpr int O_STRIDE = 15;
constexpr int CR_GROUPS = 6;  // (stage, row) groups of the CR solve
constexpr int CR_WIDE = 8;    // even stages from which a level takes stages
// dynamic shared memory a block may take on Hopper (227 KB)
constexpr int MAX_SMEM_BYTES = 232448;
constexpr int MAX_LANES_PER_BLOCK = 4;      // Schur
constexpr int MAX_CR_LANES_PER_BLOCK = 16;  // CR: 512 threads, 128 registers

// CR's padded stage count M: the least 2^k - 1 >= S
// (cyclic_reduction.padded_stages).
__host__ __device__ inline int padded_stages(int S) {
  int m = 1;
  while (m < S + 1) m *= 2;
  return m - 1;
}

// CR's odd stages over all levels, M - log2(M + 1): one coupling pair each.
__host__ __device__ inline int cr_pairs(int M) {
  int k = 0;
  while ((1 << k) < M + 1) ++k;
  return M - k;
}

// Floats of shared memory per lane with S stages; mirrored by
// ops/admm_cuda.py (lane_smem_bytes), which derives N_MAX and N_MAX_CR
// from it.
__host__ __device__ inline int lane_floats(int S, bool cr) {
  if (cr) {
    const int M = padded_stages(S);
    return (CR_SCALARS * S + (DINV_STRIDE + NW) * M
            + 2 * O_STRIDE * cr_pairs(M) + 3) & ~3;
  }
  return ((SCALARS * S + 3) & ~3) + GX_STRIDE * S + ((GR_STRIDE * S + 3) & ~3)
         + SINV_STRIDE * S;
}

// Schur's lanes per block at horizon N (0: the lane does not fit).
inline int lanes_per_block(int N) {
  const int bytes = lane_floats(N + 1, false) * 4;
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
// (V, Gx, Gr, Sinv: the Schur recursion; M, Dinv, X, OL, ORt: cyclic
// reduction).
struct Lane {
  int N, S, t, M, P;  // P: CR's coupling pairs
  float *AB, *beq, *Pd, *qv, *lw, *uw, *rho_w, *W, *Zw, *Yeq, *Yw, *V, *Gx,
      *Gr, *Sinv, *Dinv, *X, *OL, *ORt;
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
  if (CR) {
    L.V = L.Gx = L.Gr = L.Sinv = nullptr;
    L.Dinv = p;  p += DINV_STRIDE * L.M;
    L.X = p;     p += NW * L.M;
    L.P = cr_pairs(L.M);
    L.OL = p;    p += O_STRIDE * L.P;
    L.ORt = p;
  } else {
    L.V = p;
    p = smem + (size_t)w * lane_floats(S, CR) + ((SCALARS * S + 3) & ~3);
    L.Gx = p;    p += GX_STRIDE * S;
    L.Gr = p;    p += (GR_STRIDE * S + 3) & ~3;
    L.Sinv = p;
    L.Dinv = L.X = L.OL = L.ORt = nullptr;
    L.P = 0;
  }
  return L;
}

// Slot of padded stage i in CR's Dinv and X: elimination order.  Stage i
// is eliminated at level l = the number of trailing one bits of i, as even
// stage u = (i + 1) >> (l + 1) of that level; the levels before l
// eliminated (M + 1) - ((M + 1) >> l) stages.  M1 = M + 1.  The last
// stage, (M - 1) / 2, takes slot M - 1.
__device__ __forceinline__ int cr_slot(int M1, int i) {
  const int v = i + 1;
  const int l = __ffs(v) - 1;
  return (M1 - (M1 >> l)) + (v >> (l + 1));
}

// The coupling of stage i >= 1 of a CR level to its stage i - 1, the
// level's pairs starting at pair `pairs`: odd i is odd stage (i - 1) / 2's
// OL, even i is even stage i / 2's left coupling, which is odd stage
// i / 2 - 1's ORt (transposed).  Element (r, c) of the 3x5 coupling is
// L.OL[at + r * rs + c * cs] (ORt follows OL: one base keeps the stores in
// shared memory).
struct Coupling {
  int at, rs, cs;
};
__device__ __forceinline__ Coupling coupling_of(const Lane& L, int pairs,
                                                int i) {
  if (i & 1) return {(pairs + ((i - 1) >> 1)) * O_STRIDE, NW, 1};
  return {(L.P + pairs + (i >> 1) - 1) * O_STRIDE, 1, NX};
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

// Step sizes, couplings C_n and the diagonal blocks of one factor
// (stage-parallel).  Schur: D_n into Sinv's slot n (factor() forms C_n
// itself).  CR: D_n
// into Dinv's slot of stage n, C_n into level 0's pairs (coupling_of),
// identity blocks and zero couplings on the pad stages.  polish: boost the
// rows whose Zw sits at a finite bound.
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
    float* D = CR ? L.Dinv + cr_slot(L.M + 1, s) * DINV_STRIDE
                  : L.Sinv + s * SINV_STRIDE;
    if (s < N) {
      const float* ab = L.AB + s * 15;
      if constexpr (CR) {
        const Coupling c = coupling_of(L, 0, s + 1);
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j)
            L.OL[c.at + i * c.rs + j * c.cs] = -(rho_eq * ab[i * NW + j]);
      }
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
      float* D = L.Dinv + cr_slot(L.M + 1, s) * DINV_STRIDE;
#pragma unroll
      for (int e = 0; e < NW * NW; ++e)
        D[e] = (e % (NW + 1) == 0) ? 1.f : 0.f;
      const Coupling c = coupling_of(L, 0, s);
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j) L.OL[c.at + i * c.rs + j * c.cs] = 0.f;
    }
  }
  __syncwarp();
}

// Where G_n[i][j], j >= 2 of row 2 or j >= 3, lies in Gr's slot n.
__device__ __forceinline__ int gr_at(int i, int j) {
  return j < NX ? 0 : 1 + 2 * i + (j - NX);
}

// Schur recursion S_0 = D_0, S_n = D_n - G_{n-1} C_{n-1}' (x-x block),
// G_{n-1} = C_{n-1} S_{n-1}^-1 with C_{n-1} = -(rho_eq AB_{n-1}), in stage
// order; Sinv_{n-1} is carried in registers.  Thread 0 stores Sinv_n over
// D_n and G_{n-1} into Gx and Gr: the block LDL' factors of substitute().
__device__ __forceinline__ void factor(const Lane& L, float rho_eq) {
  float prev[NW][NW];
  for (int n = 0; n <= L.N; ++n) {
    float a[NW][NW], inv[NW][NW];
    load25(L.Sinv + n * SINV_STRIDE, a);
    if (n > 0) {
      const float* ab = L.AB + (n - 1) * 15;
      float C[NX][NW], G[NX][NW];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j) C[i][j] = -(rho_eq * ab[i * NW + j]);
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
      if (L.t == 0) {
        float4* gx = reinterpret_cast<float4*>(L.Gx + (n - 1) * GX_STRIDE);
        gx[0] = make_float4(G[0][0], G[0][1], G[0][2], G[1][0]);
        gx[1] = make_float4(G[1][1], G[1][2], G[2][0], G[2][1]);
        float* gr = L.Gr + (n - 1) * GR_STRIDE;
        gr[0] = G[2][2];
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = NX; j < NW; ++j) gr[gr_at(i, j)] = G[i][j];
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

// What a chain reads for one stage: G_n's x-x block (a, b: Gx's slot; g22)
// and three values of V (the chain's x-rows).
struct ChainOperands {
  float4 a, b;
  float g22, v0, v1, v2;
};

__device__ __forceinline__ ChainOperands chain_load(const Lane& L, int n,
                                                    int vs) {
  const float4* gx = reinterpret_cast<const float4*>(L.Gx + n * GX_STRIDE);
  const float* v = L.V + vs * NW;
  return {gx[0], gx[1], L.Gr[n * GR_STRIDE], v[0], v[1], v[2]};
}

// L y = b, the x-rows' chain, on thread 0: y_{n+1}[x] = ((V_{n+1}[x] -
// G_n[:, 0] y_n[0]) - G_n[:, 1] y_n[1]) - G_n[:, 2] y_n[2] into V, where
// V_{n+1}[x] already holds b_{n+1}[x] less G_n's u-terms.
__device__ __forceinline__ void forward_step(const Lane& L, int n,
                                             const ChainOperands& o,
                                             float (&y)[NX]) {
  const float y0 = ((o.v0 - o.a.x * y[0]) - o.a.y * y[1]) - o.a.z * y[2];
  const float y1 = ((o.v1 - o.a.w * y[0]) - o.b.x * y[1]) - o.b.y * y[2];
  const float y2 = ((o.v2 - o.b.z * y[0]) - o.b.w * y[1]) - o.g22 * y[2];
  float* v = L.V + (n + 1) * NW;
  v[0] = y[0] = y0;
  v[1] = y[1] = y1;
  v[2] = y[2] = y2;
}

// L' w = z, the x-rows' chain, on thread 0: w_n[x] = z_n[x] - G_n[:, x]'
// w_{n+1}[x] into V (the sum over G_n's rows from the last), from w_N =
// z_N.
__device__ __forceinline__ void backward_step(const Lane& L, int n,
                                              const ChainOperands& o,
                                              float (&w)[NX]) {
  const float w0 = o.v0 - ((o.b.z * w[2] + o.a.w * w[1]) + o.a.x * w[0]);
  const float w1 = o.v1 - ((o.b.w * w[2] + o.b.x * w[1]) + o.a.y * w[0]);
  const float w2 = o.v2 - ((o.g22 * w[2] + o.b.y * w[1]) + o.a.z * w[0]);
  float* v = L.V + n * NW;
  v[0] = w[0] = w0;
  v[1] = w[1] = w1;
  v[2] = w[2] = w2;
}

// The two chains of a solve, on thread 0 alone (the other threads wait at
// the __syncwarp that follows).  Each stage's operands are loaded a stage
// ahead in program order, alternating between two register sets, and
// before the store that rewrites the values they read.  The compiler still
// sinks a conditional load below the loop's exit test, next to its use, so
// a stage can wait out that load's latency.
__device__ __forceinline__ void forward_chain(const Lane& L) {
  if (L.t != 0) return;
  const int N = L.N;
  float y[NX] = {L.V[0], L.V[1], L.V[2]};
  ChainOperands A = chain_load(L, 0, 1), B;
  for (int n = 0; n < N; n += 2) {
    if (n + 1 < N) B = chain_load(L, n + 1, n + 2);
    forward_step(L, n, A, y);
    if (n + 1 == N) break;
    if (n + 2 < N) A = chain_load(L, n + 2, n + 3);
    forward_step(L, n + 1, B, y);
  }
}

__device__ __forceinline__ void backward_chain(const Lane& L) {
  if (L.t != 0) return;
  const int N = L.N;
  float w[NX] = {L.V[N * NW], L.V[N * NW + 1], L.V[N * NW + 2]};
  ChainOperands A = chain_load(L, N - 1, N - 1), B;
  for (int n = N - 1; n >= 0; n -= 2) {
    if (n > 0) B = chain_load(L, n - 1, n - 1);
    backward_step(L, n, A, w);
    if (n == 0) break;
    if (n > 1) A = chain_load(L, n - 2, n - 2);
    backward_step(L, n - 1, B, w);
  }
}

// M w = V in place by the block LDL' factors of factor(): M = L diag(S) L'
// with L's sub-diagonal blocks pad(G_n).  Five passes, a __syncwarp apart:
// 1. stage-parallel: V_{n+1}[x] = (V_{n+1}[x] - G_n[:, 4] V_n[4]) - G_n[:, 3]
//    V_n[3] (y_n[u] = b_n[u], known before the chain);
// 2. forward_chain: y_{n+1}[x];
// 3. stage-parallel: z_n = Sinv_n y_n;
// 4. backward_chain: w_n[x];
// 5. stage-parallel: w_n[u] = z_n[u] - G_n[:, u]' w_{n+1}[x].
// Plain version: ops/ltv_qp.py _solve, the same operations in this order.
// The stage-parallel passes read G_n's u-columns from Gr, whose odd stride
// keeps the 32 threads' reads on distinct banks.
__device__ __forceinline__ void substitute(const Lane& L) {
  const int N = L.N;
  float* V = L.V;
  for (int s = L.t; s < N; s += WARP) {
    const float* g = L.Gr + s * GR_STRIDE;
    const float u3 = V[s * NW + 3], u4 = V[s * NW + 4];
    float* v = V + (s + 1) * NW;
#pragma unroll
    for (int i = 0; i < NX; ++i)
      v[i] = (v[i] - g[gr_at(i, 4)] * u4) - g[gr_at(i, 3)] * u3;
  }
  __syncwarp();
  forward_chain(L);
  __syncwarp();
  for (int s = L.t; s <= N; s += WARP) {
    float m[NW][NW], y[NW];
    load25(L.Sinv + s * SINV_STRIDE, m);
#pragma unroll
    for (int j = 0; j < NW; ++j) y[j] = V[s * NW + j];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      float acc = m[i][0] * y[0];
#pragma unroll
      for (int j = 1; j < NW; ++j) acc = acc + m[i][j] * y[j];
      V[s * NW + i] = acc;
    }
  }
  __syncwarp();
  backward_chain(L);
  __syncwarp();
  for (int s = L.t; s < N; s += WARP) {
    const float* g = L.Gr + s * GR_STRIDE;
    const float* w = V + (s + 1) * NW;
    const float w0 = w[0], w1 = w[1], w2 = w[2];
#pragma unroll
    for (int j = NX; j < NW; ++j)
      V[s * NW + j] = V[s * NW + j] - ((g[gr_at(2, j)] * w2
                                        + g[gr_at(1, j)] * w1)
                                       + g[gr_at(0, j)] * w0);
  }
  __syncwarp();
}

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

// ---- block cyclic reduction (CR = true) ----
//
// Level l holds mc = ((M + 1) >> l) - 1 stages: e = (M + 1) >> (l + 1)
// even ones, in slots off .. off + e - 1 (off = (M + 1) - ((M + 1) >> l)),
// and mp = e - 1 odd ones, whose coupling pairs start at pair off - l; odd
// stage u is padded stage ((u + 1) << (l + 1)) - 1, between even stages u
// and u + 1, and is stage u of level l + 1.  Every product sums its terms
// in the plain version's order (ops/cyclic_reduction.py), and skips only
// terms that the plain version adds as +0 (x - 0 = x bit for bit, NaN and
// -0 included).

// The 5x5 block at d (stride 25) replaced by its Gauss-Jordan inverse.
__device__ __forceinline__ void invert_block(float* d) {
  float a[NW][NW], inv[NW][NW];
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) a[i][j] = d[i * NW + j];
  gj_inverse(a, inv);
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) d[i * NW + j] = inv[i][j];
}

// Factor, one thread a stage: per level, invert the even stages' blocks in
// place; then each odd stage u, with OL = its coupling to even stage u,
// OR = even stage u + 1's coupling to it, and Dinv_u, Dinv_u+1:
//   D' = (D - OL Dinv_u OL' [x-x block]) - OR' Dinv_u+1[x, x] OR,
//   O' = -(OL Dinv_u[:, x] OR_prev)   (OR_prev: odd stage u - 1's OR;
// u = 0 has no left neighbour and its O' is never read),
// O' written as the coupling of stage u of level l + 1 to its stage u - 1.
__device__ __forceinline__ void cr_factor(const Lane& L) {
  const int M1 = L.M + 1;
  for (int l = 0; (M1 >> l) > 2; ++l) {
    const int e = M1 >> (l + 1), mp = e - 1, off = M1 - (M1 >> l);
    const float* OLl = L.OL + (off - l) * O_STRIDE;
    const float* ORl = L.ORt + (off - l) * O_STRIDE;
    for (int u = L.t; u < e; u += WARP)
      invert_block(L.Dinv + (off + u) * DINV_STRIDE);
    __syncwarp();
    for (int u = L.t; u < mp; u += WARP) {
      // the reduced block is updated in place in shared memory (a float
      // stored and reloaded rounds nothing), which keeps the registers of
      // this step to one 3x5 coupling and one partial product
      const int q = cr_slot(M1, ((u + 1) << (l + 1)) - 1);
      const float* di0 = L.Dinv + (off + u) * DINV_STRIDE;
      const float* di1 = di0 + DINV_STRIDE;
      float* D = L.Dinv + q * DINV_STRIDE;
      float OL[NX][NW];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j) OL[i][j] = OLl[u * O_STRIDE + i * NW + j];
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
        const float* o = ORl + u * O_STRIDE;  // OR[k][j] = o[j * 3 + k]
        float Y[NX][NW];
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            float acc = di1[i * NW] * o[j * NX];
#pragma unroll
            for (int k = 1; k < NX; ++k)
              acc = acc + di1[i * NW + k] * o[j * NX + k];
            Y[i][j] = acc;
          }
#pragma unroll
        for (int i = 0; i < NW; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            float acc = o[i * NX] * Y[0][j];
#pragma unroll
            for (int k = 1; k < NX; ++k) acc = acc + o[i * NX + k] * Y[k][j];
            D[i * NW + j] = D[i * NW + j] - acc;
          }
      }
      if (u > 0) {  // O' = -(OL (Dinv_u[:, x] OR_prev)), column by column
        const float* o = ORl + (u - 1) * O_STRIDE;  // OR_prev, transposed
        const Coupling c = coupling_of(L, off + e - l - 1, u);
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          float z[NW];
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            float acc = di0[i * NW] * o[j * NX];
#pragma unroll
            for (int k = 1; k < NX; ++k)
              acc = acc + di0[i * NW + k] * o[j * NX + k];
            z[i] = acc;
          }
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            float acc = OL[i][0] * z[0];
#pragma unroll
            for (int k = 1; k < NW; ++k) acc = acc + OL[i][k] * z[k];
            L.OL[c.at + i * c.rs + j * c.cs] = -acc;
          }
        }
      }
    }
    __syncwarp();
  }
  if (L.t == 0) invert_block(L.Dinv + (L.M - 1) * DINV_STRIDE);  // the last
  __syncwarp();
}

// M w = X in place.  Down: per level, U_u = Dinv_u X_u on the even
// stages, then each odd stage X -= pad(OL U_u) and X -= OR' U_u+1[x]; the
// last stage X = Dinv X; up: per level, each even stage X_u = Dinv_u ((X_u
// - pad(OR_prev w_left)) - OL_u' w_right[x]), the odd neighbours solved.
// A level of CR_WIDE or more even stages gives a thread a stage (five
// independent row sums: the latency of one), a narrower one a (stage, row)
// pair (header); U goes from thread to thread by __shfl_sync either way.
__device__ __forceinline__ void cr_solve(const Lane& L) {
  const int M1 = L.M + 1;
  const int g = L.t / NW, r = L.t - NW * g;  // group, row
  int l = 0;
  for (; (M1 >> l) > 2; ++l) {
    const int e = M1 >> (l + 1), mp = e - 1, off = M1 - (M1 >> l);
    const float* OLl = L.OL + (off - l) * O_STRIDE;
    const float* ORl = L.ORt + (off - l) * O_STRIDE;
    if (e >= CR_WIDE) {  // a stage a thread: 32 even, 31 odd a round
      for (int base = 0; base < mp; base += WARP - 1) {
        const int u = base + L.t;
        float U[NW];  // U_u
        if (u < e) {
          const float* d = L.Dinv + (off + u) * DINV_STRIDE;
          const float* xb = L.X + (off + u) * NW;
          float b[NW];
#pragma unroll
          for (int j = 0; j < NW; ++j) b[j] = xb[j];
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            float acc = d[i * NW] * b[0];
#pragma unroll
            for (int j = 1; j < NW; ++j) acc = acc + d[i * NW + j] * b[j];
            U[i] = acc;
          }
        } else {
#pragma unroll
          for (int i = 0; i < NW; ++i) U[i] = 0.f;
        }
        float u1[NX];  // U_u+1[x], from the next thread
#pragma unroll
        for (int j = 0; j < NX; ++j) u1[j] = __shfl_down_sync(FULL, U[j], 1);
        if (L.t < WARP - 1 && u < mp) {
          float* x = L.X + cr_slot(M1, ((u + 1) << (l + 1)) - 1) * NW;
          const float* ol = OLl + u * O_STRIDE;
          const float* ort = ORl + u * O_STRIDE;
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            float xv = x[j];
            if (j < NX) {
              float acc = ol[j * NW] * U[0];
#pragma unroll
              for (int k = 1; k < NW; ++k) acc = acc + ol[j * NW + k] * U[k];
              xv = xv - acc;
            }
            float acc = ort[j * NX] * u1[0];
            acc = acc + ort[j * NX + 1] * u1[1];
            acc = acc + ort[j * NX + 2] * u1[2];
            x[j] = xv - acc;
          }
        }
      }
    } else {  // (stage, row) pairs: 6 even, 5 odd stages a round
      for (int base = 0; base < mp; base += CR_GROUPS - 1) {
        const int u = base + g;
        float uv = 0.f;  // row r of U_u
        if (g < CR_GROUPS && u < e) {
          const float* d = L.Dinv + (off + u) * DINV_STRIDE + r * NW;
          const float* b = L.X + (off + u) * NW;
          uv = d[0] * b[0];
#pragma unroll
          for (int j = 1; j < NW; ++j) uv = uv + d[j] * b[j];
        }
        float u0[NW], u1[NX];  // U_u, U_u+1[x] (lanes past 31 wrap: unused)
#pragma unroll
        for (int j = 0; j < NW; ++j) u0[j] = __shfl_sync(FULL, uv, NW * g + j);
#pragma unroll
        for (int j = 0; j < NX; ++j)
          u1[j] = __shfl_sync(FULL, uv, NW * (g + 1) + j);
        const bool odd = g < CR_GROUPS - 1 && u < mp;
        float x = 0.f;
        int q = 0;
        if (odd) {  // row r of odd stage u
          q = cr_slot(M1, ((u + 1) << (l + 1)) - 1);
          x = L.X[q * NW + r];
          if (r < NX) {
            const float* o = OLl + u * O_STRIDE + r * NW;
            float acc = o[0] * u0[0];
#pragma unroll
            for (int j = 1; j < NW; ++j) acc = acc + o[j] * u0[j];
            x = x - acc;
          }
          const float* o = ORl + u * O_STRIDE + r * NX;
          float acc = o[0] * u1[0];
          acc = acc + o[1] * u1[1];
          acc = acc + o[2] * u1[2];
          x = x - acc;
        }
        if (e > 2) {
          if (odd) L.X[q * NW + r] = x;
        } else {  // the last level's one odd stage is the last stage
          float b[NW];
#pragma unroll
          for (int j = 0; j < NW; ++j) b[j] = __shfl_sync(FULL, x, j);
          if (L.t < NW) {
            const float* d = L.Dinv + (L.M - 1) * DINV_STRIDE + r * NW;
            float w = d[0] * b[0];
#pragma unroll
            for (int j = 1; j < NW; ++j) w = w + d[j] * b[j];
            L.X[(L.M - 1) * NW + r] = w;
          }
        }
      }
    }
    __syncwarp();
  }
  for (--l; l >= 0; --l) {
    const int e = M1 >> (l + 1), mp = e - 1, off = M1 - (M1 >> l);
    const float* OLl = L.OL + (off - l) * O_STRIDE;
    const float* ORl = L.ORt + (off - l) * O_STRIDE;
    if (e >= CR_WIDE) {  // a stage a thread
      for (int u = L.t; u < e; u += WARP) {
        const int k = off + u;
        float b[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) b[j] = L.X[k * NW + j];
        if (u > 0) {  // the odd neighbour on the left: OR_prev
          const float* o = ORl + (u - 1) * O_STRIDE;
          const float* wl = L.X + cr_slot(M1, (u << (l + 1)) - 1) * NW;
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            float acc = o[i] * wl[0];
#pragma unroll
            for (int j = 1; j < NW; ++j) acc = acc + o[j * NX + i] * wl[j];
            b[i] = b[i] - acc;
          }
        }
        if (u < mp) {  // the odd neighbour on the right: OL_u'
          const float* o = OLl + u * O_STRIDE;
          const float* wr = L.X + cr_slot(M1, ((u + 1) << (l + 1)) - 1) * NW;
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            float acc = o[j] * wr[0];
            acc = acc + o[NW + j] * wr[1];
            acc = acc + o[2 * NW + j] * wr[2];
            b[j] = b[j] - acc;
          }
        }
        const float* d = L.Dinv + k * DINV_STRIDE;
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          float w = d[i * NW] * b[0];
#pragma unroll
          for (int j = 1; j < NW; ++j) w = w + d[i * NW + j] * b[j];
          L.X[k * NW + i] = w;
        }
      }
    } else {  // (stage, row) pairs: 6 even stages a round
      for (int base = 0; base < e; base += CR_GROUPS) {
        const int u = base + g, k = off + u;
        const bool even = g < CR_GROUPS && u < e;
        float b = 0.f;  // row r of the even stage's right-hand side
        if (even) {
          b = L.X[k * NW + r];
          if (u > 0 && r < NX) {  // the odd neighbour on the left: OR_prev
            const float* o = ORl + (u - 1) * O_STRIDE + r;
            const float* wl = L.X + cr_slot(M1, (u << (l + 1)) - 1) * NW;
            float acc = o[0] * wl[0];
#pragma unroll
            for (int j = 1; j < NW; ++j) acc = acc + o[j * NX] * wl[j];
            b = b - acc;
          }
          if (u < mp) {  // the odd neighbour on the right: OL_u'
            const float* o = OLl + u * O_STRIDE + r;
            const float* wr = L.X + cr_slot(M1, ((u + 1) << (l + 1)) - 1) * NW;
            float acc = o[0] * wr[0];
            acc = acc + o[NW] * wr[1];
            acc = acc + o[2 * NW] * wr[2];
            b = b - acc;
          }
        }
        float bv[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) bv[j] = __shfl_sync(FULL, b, NW * g + j);
        if (even) {  // row r of Dinv_u b over the thread's own element
          const float* d = L.Dinv + k * DINV_STRIDE + r * NW;
          float w = d[0] * bv[0];
#pragma unroll
          for (int j = 1; j < NW; ++j) w = w + d[j] * bv[j];
          L.X[k * NW + r] = w;
        }
      }
    }
    __syncwarp();
  }
}

// (Aeq w)[s][i] with stage s's w at w and stage s - 1's at wp (X's slots)
__device__ __forceinline__ float req_at(const Lane& L, const float* wp,
                                        const float* w, int s, int i) {
  if (s == 0) return -w[i];
  const float* ab = L.AB + (s - 1) * 15 + i * NW;
  float acc = ab[0] * wp[0];
#pragma unroll
  for (int j = 1; j < NW; ++j) acc = acc + ab[j] * wp[j];
  return acc - w[i];
}

// iteration() with cyclic reduction: the right-hand side is written
// straight into X's slots (the pad stages' set to zero), solved in place,
// and the relaxation reads the solution from there.  Kept apart from
// iteration() so that the Schur kernels compile as before.
__device__ __forceinline__ void cr_iteration(const Lane& L,
                                             const SolverParams& p,
                                             float rho_eq) {
  const int M1 = L.M + 1;
  // right-hand side, stage-parallel (weq = rho_eq beq - Yeq)
  for (int s = L.t; s < L.M; s += WARP) {
    float* x = L.X + cr_slot(M1, s) * NW;
    if (s >= L.S) {
#pragma unroll
      for (int j = 0; j < NW; ++j) x[j] = 0.f;
      continue;
    }
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
      x[j] = (((p.sigma * L.W[e] - L.qv[e]) + eqT(L, wn, ws, s, j))
              + L.rho_w[e] * L.Zw[e]) - L.Yw[e];
    }
  }
  __syncwarp();
  cr_solve(L);
  // relaxation, projection and dual updates, stage-parallel
  for (int s = L.t; s < L.S; s += WARP) {
    const float* x = L.X + cr_slot(M1, s) * NW;
    const float* xp = s > 0 ? L.X + cr_slot(M1, s - 1) * NW : x;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float b = L.beq[s * NX + i];
      const float r = req_at(L, xp, x, s, i);
      const float zpre = p.alpha * r + p.one_m_alpha * b;
      L.Yeq[s * NX + i] = L.Yeq[s * NX + i] + rho_eq * (zpre - b);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int e = s * NW + j;
      const float wt = x[j], rw = L.rho_w[e], yw = L.Yw[e];
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
    factor(L, rho * p.eq_scale);
  const float rho_eq = rho * p.eq_scale;
  for (int k = 0; k < iters; ++k) {
    if constexpr (CR)
      cr_iteration(L, p, rho_eq);
    else
      iteration(L, p, rho_eq);
  }
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

// Launch shape of ADMM kernel `fn` (an instantiation of K1's or K3's
// kernel with stage solver CR) for B lanes at horizon N: lanes a block,
// their dynamic shared memory, and, where per_sm is given, the lanes
// resident on one SM by CUDA's occupancy calculator.  Schur: as many lanes
// as fit, at most MAX_LANES_PER_BLOCK.  CR: of 1, 2, 4, .. 16 lanes a
// block, the fewest that keep as many lanes resident on an SM as the
// batch can use, B / SMs up to the most any count keeps: a full card
// takes the densest blocks, a small batch one lane a block on as many SMs
// as it has lanes (the residencies are cached per horizon).  Sets the
// kernel's shared-memory attributes; returns the first CUDA error.
template <bool CR, typename Kernel>
cudaError_t launch_shape(Kernel* fn, int N, int B, int* lanes, int* smem,
                         int* per_sm) {
  *lanes = *smem = 0;
  if (N < 1) return cudaErrorInvalidValue;
  const int bytes = lane_floats(N + 1, CR) * 4;
  cudaError_t err;
  if constexpr (!CR) {
    *lanes = lanes_per_block(N);
    if (*lanes < 1) return cudaErrorInvalidValue;
    *smem = *lanes * bytes;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  } else {
    if (bytes > MAX_SMEM_BYTES) return cudaErrorInvalidValue;
    constexpr int CACHED = 1024, COUNTS = 5;  // 1, 2, 4, 8, 16 lanes a block
    static int resident[CACHED][COUNTS];  // lanes per SM; all 0: not yet
    static int sms = 0;
    int res[COUNTS] = {0, 0, 0, 0, 0};
    if (N < CACHED)
      for (int i = 0; i < COUNTS; ++i) res[i] = resident[N][i];
    if (res[0] == 0) {
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   MAX_SMEM_BYTES);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      for (int i = 0; i < COUNTS && err == cudaSuccess; ++i) {
        const int n = 1 << i;
        if (n * bytes > MAX_SMEM_BYTES) break;
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, fn, WARP * n, n * bytes);
        res[i] = blocks * n;
      }
      if (err != cudaSuccess) return err;
      if (N < CACHED)
        for (int i = 0; i < COUNTS; ++i) resident[N][i] = res[i];
    }
    int most = 0;
    for (int i = 0; i < COUNTS; ++i) most = res[i] > most ? res[i] : most;
    if (most < 1) return cudaErrorInvalidValue;
    const long long want = ((long long)B + sms - 1) / (sms > 0 ? sms : 1);
    const int need = want < most ? (int)want : most;
    int i = 0;
    while (res[i] < need) ++i;
    *lanes = 1 << i;
    *smem = *lanes * bytes;
  }
  if (per_sm != nullptr) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        WARP * *lanes, *smem);
    if (err != cudaSuccess) return err;
    *per_sm = blocks * *lanes;
  }
  return cudaSuccess;
}

}  // namespace
