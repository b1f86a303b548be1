// K7: the singular value decomposition of every matrix of a float32 batch,
// one thread block per matrix, all in one launch and with no host read.
//
// Replaces no TPU kernel: tnax leaves jnp.linalg.svd to XLA (tnax/bmps.py
// :217, :446, :468, :765, :786: svd_fixed, truncate_center, the zip-up's
// core and the polish's singular values). The port added it because
// torch.linalg.svd and torch.linalg.svdvals check cuSOLVER's info on the
// host after every call, so every SVD of a boundary row absorption
// synchronized the card (about 96 a D=48 row). bmps.svd_fixed and
// bmps.svdvals launch this kernel wherever a float32 matrix on the card
// fits it (kernels.svd.engages).
//
// What it computes, for each M (m x n) with p = min(m, n) <= 128: S (p,
// descending) and, when asked, U (m x p) and Vh (p x n) with svd_fixed's
// column-sign rule (a column of U and the row of Vh both mostly negative
// are negated). The launcher hands over the wide orientation X (p x q,
// q = max(m, n)), X = M or M^T by strides, and writes X's factors U_X
// (p x p) and V_X (q x p) through strides that put them where M's go.
//   - X / 2^e, 2^e its largest |entry| floored to a power of two (the
//     scaling of LAPACK's gesvd), so that no square over- or underflows;
//   - the Householder QR X^T = Q1 R (LAPACK's geqr2, one barrier a
//     column, the columns in their warps' registers and only the
//     reflectors in shared memory), then one-sided (Hestenes) Jacobi on
//     the p columns of Z = R^T: Z J = W = U S with orthogonal columns.
//     Jacobi on R^T is the preconditioning of Drmac and Veselic: its
//     columns are nearly orthogonal already, and the captured boundary
//     matrices take 4-6 sweeps where X^T takes 6-12. U = W / S and
//     V = Q1 J, both orthonormal;
//   - where X^T does not fit in registers (the zip-up's 128 x 768 core at
//     D=48), R comes from a Householder QR of [R; chunk] over chunks of
//     X^T's rows streamed from device memory (R alone, as TSQR), the
//     Jacobi accumulates nothing and V = X^T U / S, a product in the same
//     launch: its rows are exact to rounding where S is not small beside
//     S[0], and S Vh = U^T X, what the zip-up carries, is exact to
//     rounding everywhere;
//   - the Jacobi's rotation is K6's (csrc/jacobi.cuh): round-robin
//     pairs, LAPACK sgesvj's tolerance sqrt(p) eps, and negligible
//     columns never rotated: here those of square norm at most eps^2
//     ||Z||_F^2, below the rounding of the largest column, which take
//     S = 0 and zero vectors. K6's floor, 8 eps ||Z||_F, would zero
//     singular values between eps and 8 eps ||Z||_F, which float32
//     resolves to about an eps and a zip-up core may keep: a chimera-2048
//     ladder core holds its 14th-16th at 6.8-8.3 eps S[0], the 16th 4.2
//     eps above the 17th. A pair to a group of G lanes, one barrier a
//     round, sweeps until one rotates nothing, at most 30; a round sums
//     only the pair's inner product (the columns' norms are updated by
//     each rotation), and a warp's four groups read disjoint windows of
//     eight banks.
// FP32 FMA throughout, no tensor cores: the configuration states float32.
//
// What bounds it: at the boundary's shapes a few tens of MFLOP a matrix
// (the 128 x 768 core: the QR's 2 q p^2 - 2 p^3 / 3 = 23.8 M, 4-6 Jacobi
// sweeps of 6 p^3 / 2 = 6.3 M each, the product's 2 p^2 q = 25.2 M), some
// microseconds at 67 TFLOP/s; one block holds a matrix, so a matrix runs
// on one SM and its chain of QR columns and Jacobi rounds, each ended by a
// barrier, sets its time: a round moves both columns of every pair through
// shared memory.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "jacobi.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 512;               // sixteen warps
constexpr int NW = NT / 32;
constexpr int MAXP = 128;             // min(m, n)
// X^T held whole up to these rows (128 where p > 64: a warp's columns of
// V live in its registers)
constexpr int MAX_DIRECT_Q = 256, MAX_DIRECT_Q_L = 128;
// rows a lane of a column held in registers by the QR: X^T whole, or a
// chunk of it, has at most 32 MR rows
constexpr int MR = 8;
constexpr int SMEM_MAX = 232448;      // bytes: an H100 block's opt-in limit
constexpr int TW = 128;               // columns of X a tile of the product
// the misc region, in floats: the reflectors' tau, the singular values,
// their order, the flips, U's column and V's row extremes, 1 / S, the
// Jacobi's column norms, the block reductions' partials, the QR's two
// reflector buffers
constexpr int M_TAU = 0, M_S = MAXP, M_ORD = 2 * MAXP, M_FLIP = 3 * MAXP,
              M_UMIN = 4 * MAXP, M_UMAX = 5 * MAXP, M_VMIN = 6 * MAXP,
              M_VMAX = 7 * MAXP, M_INV = 8 * MAXP, M_NRM = 9 * MAXP,
              M_RED = 10 * MAXP, M_V = M_RED + 64, MISC = M_V + 64 * MR;
constexpr int BUDGET = SMEM_MAX / 4 - MISC;   // floats for the matrices

struct Args {
  const float* x;     // X (p x q): (i, c) at x + b xb + i xi + c xc
  long long xb, xi, xc;
  float* s;           // S (B, p): (b, r) at s + b sb + r
  long long sb;
  float* u;           // U_X (p x p): (i, r) at u + b ub + i ui + r ur
  long long ub, ui, ur;
  float* v;           // V_X (q x p): (c, r) at v + b vb + c vc + r vr
  long long vb, vc, vr;
  int* sweeps;        // (B,) the Jacobi's sweeps, or null
  int p, q;
  int h;              // rows of X^T a chunk (the streamed path), 0: whole
  int vectors;        // U and V besides S
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// sums of K values over the warp at once; every lane gets the same bits
template <int K>
__device__ __forceinline__ void warp_sum_n(float (&v)[K]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(FULL, v[k], o);
}

// over the G lanes of an aligned group
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// a sum or maximum over the block; every thread gets the same bits
__device__ float block_sum(float v, float* red, int t) {
  v = warp_sum(v);
  if ((t & 31) == 0) red[t >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += red[i];
  __syncthreads();
  return s;
}

__device__ float block_max(float v, float* red, int t) {
  v = warp_max(v);
  if ((t & 31) == 0) red[t >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) s = fmaxf(s, red[i]);
  __syncthreads();
  return s;
}

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// X's element (i, c) of matrix z, scaled by 2^-e
__device__ __forceinline__ float xin(const Args& g, int z, int i, int c,
                                     int e) {
  return ldexpf(g.x[z * g.xb + i * g.xi + c * g.xc], -e);
}

// ---- Householder QR --------------------------------------------------------

// The QR of p columns held in the registers of their warps: column j in
// warp j % NW, slot j / NW, its rows lane + 32 m (m < MR) in x[slot][m].
// Reflector k is made by its owner (slarfg: v = [1; tail / (alpha -
// beta)], tau, beta onto the head) and written to the shared buffer
// V[k % 2] (n rows, zeros above its head); every warp applies it to its
// columns j > k, their sums in one round of shuffles; the owner of column
// k + 1 then makes reflector k + 1: one barrier a column, and shared
// memory carries only the reflectors.
//   - IN_PLACE (geqr2 on X^T whole, n = q rows): the head is the column's
//     row k, in its registers; reflector k's rows below the head go to
//     Yv (column k, stride ys) for Q1 later, and the registers end as R;
//   - else (a chunk of X^T's rows below R, TSQR): the head is R[k, j] in
//     shared memory (Rm, row stride rs), the tail the chunk's n rows,
//     which end as zeros.
// A tail whose square norm is below 1e-30 (every entry below 1e-15 of the
// matrix's largest |entry|, which the scaling makes 1 to 2) is left as it
// is, tau = 0.
// reflector k from slot sk of this warp's columns (see householder)
template <int CPW, bool IN_PLACE>
__device__ __forceinline__ void reflector(float (&x)[CPW][MR], float* Rm,
                                          int rs, float* Yv, int ys,
                                          float* V, int n, int k,
                                          float* tau, int lane) {
  const int sk = k / NW;
  float col[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    col[m] = x[0][m];
#pragma unroll
    for (int s = 1; s < CPW; ++s)
      if (s == sk) col[m] = x[s][m];
  }
  float alpha, ss = 0.f;
  if (IN_PLACE) {
    float xa = 0.f;
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (m == (k >> 5)) xa = col[m];
    alpha = __shfl_sync(FULL, xa, k & 31);
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (lane + 32 * m > k && lane + 32 * m < n)
        ss = fmaf(col[m], col[m], ss);
  } else {
    alpha = Rm[k * rs + k];
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (lane + 32 * m < n) ss = fmaf(col[m], col[m], ss);
  }
  ss = warp_sum(ss);
  if (!(ss >= 1e-30f)) {
    if (lane == 0) tau[k] = 0.f;
    return;
  }
  float* vb = V + (k & 1) * 32 * MR;
  const float beta = -copysignf(sqrtf(fmaf(alpha, alpha, ss)), alpha);
  const float scal = 1.f / (alpha - beta);
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int row = lane + 32 * m;
    float v, xr;
    if (IN_PLACE) {
      v = row < k ? 0.f : (row == k ? 1.f : col[m] * scal);
      xr = row < k ? col[m] : (row == k ? beta : 0.f);
      if (row > k && row < n) Yv[k * ys + row] = v;
    } else {
      v = col[m] * scal;
      xr = 0.f;
    }
    if (row < n) vb[row] = v;
    col[m] = xr;
  }
#pragma unroll
  for (int s = 0; s < CPW; ++s)
    if (s == sk)
#pragma unroll
      for (int m = 0; m < MR; ++m) x[s][m] = col[m];
  if (lane == 0) {
    tau[k] = (beta - alpha) / beta;
    if (!IN_PLACE) Rm[k * rs + k] = beta;
  }
}

template <int CPW, bool IN_PLACE>
__device__ void householder(float (&x)[CPW][MR], float* Rm, int rs,
                            float* Yv, int ys, float* V, int n, int p,
                            float* tau, int t) {
  const int w = t >> 5, lane = t & 31;
  if (w == 0)
    reflector<CPW, IN_PLACE>(x, Rm, rs, Yv, ys, V, n, 0, tau, lane);
  __syncthreads();
  for (int k = 0; k < p; ++k) {
    const float tk = tau[k];
    if (tk != 0.f) {
      const float* vb = V + (k & 1) * 32 * MR;
      float vr[MR], d[CPW], h0[CPW];
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int row = lane + 32 * m;
        vr[m] = row < n ? vb[row] : 0.f;
      }
#pragma unroll
      for (int s = 0; s < CPW; ++s) {
        const int j = w + NW * s;
        d[s] = 0.f;
        h0[s] = !IN_PLACE && j > k && j < p ? Rm[k * rs + j] : 0.f;
        if (j > k && j < p)
#pragma unroll
          for (int m = 0; m < MR; ++m) d[s] = fmaf(vr[m], x[s][m], d[s]);
      }
      warp_sum_n<CPW>(d);
#pragma unroll
      for (int s = 0; s < CPW; ++s) {
        const int j = w + NW * s;
        if (j > k && j < p) {
          const float du = tk * (h0[s] + d[s]);
          if (!IN_PLACE && lane == 0) Rm[k * rs + j] = h0[s] - du;
#pragma unroll
          for (int m = 0; m < MR; ++m) x[s][m] = fmaf(-du, vr[m], x[s][m]);
        }
      }
    }
    if (k + 1 < p && (k + 1) % NW == w)
      reflector<CPW, IN_PLACE>(x, Rm, rs, Yv, ys, V, n, k + 1, tau, lane);
    __syncthreads();
  }
}

// X^T's rows c0 .. c0 + n - 1 of this warp's columns into x (zeros past n
// and p), scaled by 2^-e
template <int CPW>
__device__ void load_columns(float (&x)[CPW][MR], const Args& g, int z,
                             int c0, int n, int e, int t) {
  const int w = t >> 5, lane = t & 31;
#pragma unroll
  for (int s = 0; s < CPW; ++s) {
    const int j = w + NW * s;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int row = lane + 32 * m;
      x[s][m] = j < g.p && row < n ? xin(g, z, j, c0 + row, e) : 0.f;
    }
  }
}

// ---- one-sided Jacobi ------------------------------------------------------

// One-sided Jacobi on the pc columns of Z (p rows, column stride zs; pc =
// p rounded up to even, the last column zero where p is odd), with ACC the
// rotations accumulated in J (same layout, from the identity): a round's
// pc / 2 disjoint round-robin pairs go to as many groups of G lanes, one
// barrier a round; sweeps until one rotates
// nothing, at most 30. The columns' square norms (nrm) are summed at each
// sweep's start and updated by each rotation (Hestenes: al - t ga, be +
// t ga), so a round sums only the pair's inner product; the sweep that
// ends the loop rotates nothing, so it decides on exact norms. Returns the
// sweeps run.
template <int G, int RPL, bool ACC>
__device__ int jacobi(float* Z, float* J, float* nrm, int zs, int p, int pc,
                      float floor2, int t) {
  static_assert(G == 8 && RPL % 4 == 0, "four groups a warp, 32-row steps");
  const int h = t / G, i = t % G, npairs = pc / 2;
  const int w = t >> 5, lane = t & 31;
  const float tol = sqrtf(static_cast<float>(p)) * FLT_EPSILON;
  const bool act = h < npairs;
  // a warp whose groups hold no pair only meets the barriers
  const bool busy = (t & ~31) / G < npairs;
  int sweep = 0;
  while (sweep < 30) {
    ++sweep;
    for (int a = w; a < pc; a += NW) {
      float ss = 0.f;
      for (int b = lane; b < p; b += 32)
        ss = fmaf(Z[a * zs + b], Z[a * zs + b], ss);
      ss = warp_sum(ss);
      if (lane == 0) nrm[a] = ss;
    }
    __syncthreads();
    int rotated = 0;
    for (int r = 0; r < pc - 1; ++r) {
      if (!busy) {
        __syncthreads();
        continue;
      }
      // every lane of a warp runs the sums, as the shuffles want; a group
      // past the round's pairs sums zeros and writes nothing
      int cp = 0, cq = 1;
      if (act) {
        // round-robin without a division: n1 with r for the first group,
        // (r + h) mod n1 with (r - h) mod n1 for the others
        const int n1 = pc - 1;
        int a = r + h, b = r - h;
        a -= a >= n1 ? n1 : 0;
        b += b < 0 ? n1 : 0;
        cp = h == 0 ? r : min(a, b);
        cq = h == 0 ? n1 : max(a, b);
      }
      float* bp = Z + cp * zs;
      float* bq = Z + cq * zs;
      // the norms read before the shuffles, which order them before the
      // group's write below
      const float al = act ? nrm[cp] : 0.f, be = act ? nrm[cq] : 0.f;
      // step e of lane i: row 32 (e / 4) + 8 ((h + e) % 4) + i, so that at
      // every step the warp's four groups touch four disjoint windows of
      // eight banks (zs is a multiple of 32)
      const auto rowof = [h, i](int e) {
        return 32 * (e >> 2) + 8 * ((h + e) & 3) + i;
      };
      float xp[RPL], xq[RPL];
      float ga = 0.f;
#pragma unroll
      for (int e = 0; e < RPL; ++e) {
        const int row = rowof(e);
        xp[e] = act && row < p ? bp[row] : 0.f;
        xq[e] = act && row < p ? bq[row] : 0.f;
        ga = fmaf(xp[e], xq[e], ga);
      }
      ga = group_sum<G>(ga);
      float cs, sn, tn;
      if (act && jacobi_rotation(al, be, ga, tol, floor2, cs, sn, tn)) {
#pragma unroll
        for (int e = 0; e < RPL; ++e) {
          const int row = rowof(e);
          if (row < p) {
            bp[row] = cs * xp[e] - sn * xq[e];
            bq[row] = sn * xp[e] + cs * xq[e];
          }
        }
        if (ACC) {
          float* vp = J + cp * zs;
          float* vq = J + cq * zs;
#pragma unroll
          for (int e = 0; e < RPL; ++e) {
            const int row = rowof(e);
            if (row < p) {
              const float a = vp[row], b = vq[row];
              vp[row] = cs * a - sn * b;
              vq[row] = sn * a + cs * b;
            }
          }
        }
        if (i == 0) {
          nrm[cp] = fmaxf(fmaf(-tn, ga, al), 0.f);
          nrm[cq] = fmaf(tn, ga, be);
        }
        rotated = 1;
      }
      __syncthreads();
    }
    if (!__syncthreads_or(rotated)) break;
  }
  return sweep;
}

// ---- the outputs -----------------------------------------------------------

// The whole path's vectors: output column r (a warp's CPW columns) is
// W's column a = ord[r] over S (zero where S is), and V's column
// Q1 J[:, a], made in the warp's registers by the reflectors in Yv
// (column k below row k), last first (org2r's order); then svd_fixed's
// sign.
template <int PMAX>
__device__ void whole_vectors(const Args& g, int z, const float* Yv, int ys,
                              const float* Z, const float* J, int zs,
                              const float* misc, int t) {
  constexpr int CPW = PMAX / NW;
  constexpr int RQ = (PMAX > 64 ? MAX_DIRECT_Q_L : MAX_DIRECT_Q) / 32;
  const int w = t >> 5, lane = t & 31, p = g.p, q = g.q;
  const float* tau = misc + M_TAU;
  const float* S = misc + M_S;
  const int* ord = reinterpret_cast<const int*>(misc + M_ORD);
  float vcol[CPW][RQ], umn[CPW], umx[CPW];
#pragma unroll
  for (int c4 = 0; c4 < CPW; ++c4) {
    const int r = w + NW * c4;
    const int a = r < p ? ord[r] : 0;
    float mn = INFINITY, mx = -INFINITY;
    for (int row = lane; row < p; row += 32) {
      const float x = Z[a * zs + row];
      mn = fminf(mn, x);
      mx = fmaxf(mx, x);
    }
    // W / S has the extremes of W: S > 0
    umn[c4] = warp_min(mn);
    umx[c4] = warp_max(mx);
#pragma unroll
    for (int m = 0; m < RQ; ++m) {
      const int row = lane + 32 * m;
      vcol[c4][m] = r < p && row < p ? J[a * zs + row] : 0.f;
    }
  }
  for (int k = p - 1; k >= 0; --k) {
    const float tk = tau[k];
    if (tk == 0.f) continue;
    const float* vk = Yv + k * ys;
    float d[CPW];
#pragma unroll
    for (int c4 = 0; c4 < CPW; ++c4) d[c4] = 0.f;
#pragma unroll
    for (int m = 0; m < RQ; ++m) {
      const int row = lane + 32 * m;
      if (row >= k && row < q) {
        const float vv = row == k ? 1.f : vk[row];
#pragma unroll
        for (int c4 = 0; c4 < CPW; ++c4) d[c4] = fmaf(vv, vcol[c4][m], d[c4]);
      }
    }
    warp_sum_n<CPW>(d);
#pragma unroll
    for (int m = 0; m < RQ; ++m) {
      const int row = lane + 32 * m;
      if (row >= k && row < q) {
        const float vv = row == k ? 1.f : vk[row];
#pragma unroll
        for (int c4 = 0; c4 < CPW; ++c4)
          vcol[c4][m] = fmaf(-tk * d[c4], vv, vcol[c4][m]);
      }
    }
  }
#pragma unroll
  for (int c4 = 0; c4 < CPW; ++c4) {
    const int r = w + NW * c4;
    if (r >= p) continue;     // the same for the whole warp
    float mn = INFINITY, mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < RQ; ++m)
      if (lane + 32 * m < q) {
        mn = fminf(mn, vcol[c4][m]);
        mx = fmaxf(mx, vcol[c4][m]);
      }
    mn = warp_min(mn);
    mx = warp_max(mx);
    const int a = ord[r];
    const float s = S[a];
    const float f = fabsf(umn[c4]) > umx[c4] && fabsf(mn) > mx ? -1.f : 1.f;
    const float fu = s > 0.f ? f / s : 0.f;
    float* uo = g.u + z * g.ub + r * g.ur;
    for (int row = lane; row < p; row += 32)
      uo[row * g.ui] = fu * Z[a * zs + row];
    float* vo = g.v + z * g.vb + r * g.vr;
#pragma unroll
    for (int m = 0; m < RQ; ++m) {
      const int row = lane + 32 * m;
      if (row < q) vo[row * g.vc] = f * vcol[c4][m];
    }
  }
}

// The streamed path's vectors: U's sorted columns W / S into Us (p x us,
// row-major by U's row, zero past p), their extremes, then V_X = X^T U / S
// tile by tile of TW columns of X (Xt, p x TW, row-major), a warp eight
// rows of V^T by 32 x 4 columns, the rows' extremes through shared memory
// (the product's accumulators take the registers); then svd_fixed's
// sign, applied to the V a thread wrote by reading it back, and U.
__device__ void streamed_vectors(const Args& g, int z, int e, const float* Z,
                                 int zs, float* Us, float* Xt, float* misc,
                                 int t) {
  const int w = t >> 5, lane = t & 31, p = g.p, q = g.q;
  const int us = (p + 7) & ~7;
  const float* S = misc + M_S;
  const int* ord = reinterpret_cast<const int*>(misc + M_ORD);
  float* flip = misc + M_FLIP;
  float* umin = misc + M_UMIN;
  float* umax = misc + M_UMAX;
  float* vmin = misc + M_VMIN;
  float* vmax = misc + M_VMAX;
  float* inv = misc + M_INV;
  for (int k = t; k < p * us; k += NT) {
    const int i = k / us, r = k % us;
    float u = 0.f;
    if (r < p) {
      const int a = ord[r];
      const float s = S[a];
      u = s > 0.f ? Z[a * zs + i] / s : 0.f;
    }
    Us[k] = u;
  }
  for (int r = t; r < p; r += NT) {
    const float s = S[ord[r]];
    inv[r] = s > 0.f ? 1.f / s : 0.f;
    vmin[r] = INFINITY;
    vmax[r] = -INFINITY;
  }
  __syncthreads();
  for (int r = w; r < p; r += NW) {
    float mn = INFINITY, mx = -INFINITY;
    for (int i = lane; i < p; i += 32) {
      const float u = Us[i * us + r];
      mn = fminf(mn, u);
      mx = fmaxf(mx, u);
    }
    mn = warp_min(mn);
    mx = warp_max(mx);
    if (lane == 0) {
      umin[r] = mn;
      umax[r] = mx;
    }
  }
  const bool gact = 8 * w < p;
  float* vo = g.v + z * g.vb;
  for (int c0 = 0; c0 < q; c0 += TW) {
    const int tw = min(TW, q - c0);
    for (int k = t; k < p * TW; k += NT) {
      const int i = k / TW, cc = k % TW;
      Xt[k] = cc < tw ? xin(g, z, i, c0 + cc, e) : 0.f;
    }
    __syncthreads();
    if (gact) {
      float acc[8][4];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[rr][cc] = 0.f;
      for (int i = 0; i < p; ++i) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(Us + i * us + 8 * w);
        const float4 a1 =
            *reinterpret_cast<const float4*>(Us + i * us + 8 * w + 4);
        const float4 xv =
            *reinterpret_cast<const float4*>(Xt + i * TW + 4 * lane);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int rr = 0; rr < 8; ++rr)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[rr][cc] = fmaf(a[rr], x4[cc], acc[rr][cc]);
      }
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int r = 8 * w + rr;
        if (r >= p) continue;     // the same for the whole warp
        const float iv = inv[r];
        float mn = INFINITY, mx = -INFINITY;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int c = c0 + 4 * lane + cc;
          if (c < q) {
            const float val = acc[rr][cc] * iv;
            vo[c * g.vc + r * g.vr] = val;
            mn = fminf(mn, val);
            mx = fmaxf(mx, val);
          }
        }
        mn = warp_min(mn);
        mx = warp_max(mx);
        if (lane == 0) {
          vmin[r] = fminf(vmin[r], mn);
          vmax[r] = fmaxf(vmax[r], mx);
        }
      }
    }
    __syncthreads();
  }
  for (int r = t; r < p; r += NT)
    flip[r] = fabsf(umin[r]) > umax[r] && fabsf(vmin[r]) > vmax[r] ? -1.f
                                                                    : 1.f;
  __syncthreads();
  if (gact) {
    for (int rr = 0; rr < 8; ++rr) {
      const int r = 8 * w + rr;
      if (r >= p || flip[r] > 0.f) continue;
      for (int c = 4 * lane; c < q; c += TW)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          if (c + cc < q) vo[(c + cc) * g.vc + r * g.vr] *= -1.f;
    }
  }
  float* uo = g.u + z * g.ub;
  for (int k = t; k < p * p; k += NT) {
    const int i = k / p, r = k % p;
    uo[i * g.ui + r * g.ur] = flip[r] * Us[i * us + r];
  }
}

// ---- the kernel ------------------------------------------------------------

// PMAX: the class of p, 32, 64 or 128; a Jacobi pair to G lanes of RPL
// rows each
template <int PMAX, int G, int RPL>
__global__ void __launch_bounds__(NT, 1) svd_kernel(const Args g) {
  extern __shared__ float4 svd_smem[];
  float* sm = reinterpret_cast<float*>(svd_smem);
  const int t = threadIdx.x, z = blockIdx.x, p = g.p, q = g.q;
  const int pc = p + (p & 1), zs = (p + 31) & ~31;
  // the matrices' regions; misc after them
  float* misc = sm + BUDGET;
  float* red = misc + M_RED;
  float* tau = misc + M_TAU;
  float* S = misc + M_S;
  int* ord = reinterpret_cast<int*>(misc + M_ORD);

  // 1. the scale 2^e, and NaN out where an entry is not finite
  float mx = 0.f;
  int bad = 0;
  for (int i = t >> 5; i < p; i += NW)
    for (int c = t & 31; c < q; c += 32) {
      const float a = g.x[z * g.xb + i * g.xi + c * g.xc];
      bad |= !isfinite(a);
      mx = fmaxf(mx, fabsf(a));
    }
  if (__syncthreads_or(bad)) {
    for (int r = t; r < p; r += NT) g.s[z * g.sb + r] = NAN;
    if (g.vectors) {
      for (int k = t; k < p * p; k += NT)
        g.u[z * g.ub + (k / p) * g.ui + (k % p) * g.ur] = NAN;
      for (int k = t; k < q * p; k += NT)
        g.v[z * g.vb + (k / p) * g.vc + (k % p) * g.vr] = NAN;
    }
    if (g.sweeps != nullptr && t == 0) g.sweeps[z] = 0;
    return;
  }
  mx = block_max(mx, red, t);
  const int e = mx > 0.f ? ilogbf(mx) : 0;

  // 2. R of X^T's QR (the columns in registers), and Z = R^T (pc columns
  // of p rows, stride zs); R's row k is Z's column k
  constexpr int CPW = PMAX / NW;
  float x[CPW][MR];
  float *Yv = nullptr, *J = nullptr, *C = nullptr;
  float* Z = sm;
  float* V = misc + M_V;
  const int ys = q + 1;
  for (int k = t; k < pc * zs; k += NT) Z[k] = 0.f;
  if (g.h == 0) {
    // X^T whole, QR'd in place; the reflectors into Yv for V = Q1 J
    Yv = Z + pc * zs;
    J = Yv + align4(p * ys);
    load_columns<CPW>(x, g, z, 0, q, e, t);
    householder<CPW, true>(x, nullptr, 0, Yv, ys, V, q, p, tau, t);
    const int w = t >> 5, lane = t & 31;
#pragma unroll
    for (int s = 0; s < CPW; ++s) {
      const int j = w + NW * s;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int row = lane + 32 * m;
        if (j < p && row <= j) Z[row * zs + j] = x[s][m];
      }
    }
  } else {
    // R over chunks of h rows of X^T below it (TSQR)
    C = Z + pc * zs;
    __syncthreads();
    for (int c0 = 0; c0 < q; c0 += g.h) {
      const int hc = min(g.h, q - c0);
      load_columns<CPW>(x, g, z, c0, hc, e, t);
      householder<CPW, false>(x, Z, zs, nullptr, 0, V, hc, p, tau, t);
    }
  }
  __syncthreads();

  // 3. Jacobi on Z's columns
  float f2 = 0.f;
  for (int k = t; k < pc * zs; k += NT) f2 = fmaf(Z[k], Z[k], f2);
  const float floor2 = FLT_EPSILON * FLT_EPSILON * block_sum(f2, red, t);
  const bool acc = g.vectors && g.h == 0;
  if (acc)
    for (int k = t; k < pc * zs; k += NT)
      J[k] = k / zs == k % zs && k / zs < p ? 1.f : 0.f;
  __syncthreads();
  float* nrm = misc + M_NRM;
  const int sweeps =
      acc ? jacobi<G, RPL, true>(Z, J, nrm, zs, p, pc, floor2, t)
          : jacobi<G, RPL, false>(Z, J, nrm, zs, p, pc, floor2, t);
  if (g.sweeps != nullptr && t == 0) g.sweeps[z] = sweeps;

  // 4. the singular values (0 for a negligible column), their order, S
  {
    const int w = t >> 5, lane = t & 31;
    for (int a = w; a < p; a += NW) {
      float ss = 0.f;
      for (int b = lane; b < p; b += 32)
        ss = fmaf(Z[a * zs + b], Z[a * zs + b], ss);
      ss = warp_sum(ss);
      if (lane == 0) S[a] = ss > floor2 ? sqrtf(ss) : 0.f;
    }
  }
  __syncthreads();
  if (t < p) {
    const float s = S[t];
    int rank = 0;
    for (int b = 0; b < p; ++b) rank += S[b] > s || (S[b] == s && b < t);
    ord[rank] = t;
  }
  __syncthreads();
  for (int r = t; r < p; r += NT) g.s[z * g.sb + r] = ldexpf(S[ord[r]], e);
  if (!g.vectors) return;

  // 5. U and V with svd_fixed's sign
  if (g.h == 0) {
    whole_vectors<PMAX>(g, z, Yv, ys, Z, J, zs, misc, t);
  } else {
    const int us = (p + 7) & ~7;
    streamed_vectors(g, z, e, Z, zs, C, C + align4(p * us), misc, t);
  }
}

}  // namespace

// ---- the launcher ----------------------------------------------------------

namespace {

// whether the kernel takes p = min(m, n), q = max(m, n), and how: X^T
// whole (h = 0: Z, the reflectors and J fit) or streamed in chunks of h
// rows (Z, and U and a tile of X for the product V = X^T U / S)
bool plan(int p, int q, int vectors, int* h) {
  const int pc = p + (p & 1), zarea = pc * ((p + 31) & ~31);
  if (p < 1 || p > MAXP || q < p) return false;
  if (q <= (p > 64 ? MAX_DIRECT_Q_L : MAX_DIRECT_Q) &&
      zarea + align4(p * (q + 1)) + (vectors ? zarea : 0) <= BUDGET) {
    *h = 0;
    return true;
  }
  const int us = (p + 7) & ~7;
  if (zarea + (vectors ? align4(p * us) + p * TW : 0) > BUDGET) return false;
  *h = 32 * MR;
  return true;
}

template <int PMAX, int G, int RPL>
int launch(const Args& g, int B, int smem, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        svd_kernel<PMAX, G, RPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  svd_kernel<PMAX, G, RPL><<<B, NT, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tnax_svd_f32(const void* x, long long xb, long long xi, long long xc,
                 void* s, long long sb, void* u, long long ub, long long ui,
                 long long ur, void* v, long long vb, long long vc,
                 long long vr, void* sweeps, int B, int p, int q,
                 int vectors, void* stream) {
  int h = 0;
  if (B < 0 || !plan(p, q, vectors, &h))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Args g{static_cast<const float*>(x), xb, xi, xc,
               static_cast<float*>(s), sb, static_cast<float*>(u), ub, ui,
               ur, static_cast<float*>(v), vb, vc, vr,
               static_cast<int*>(sweeps), p, q, h, vectors};
  // the misc region sits at BUDGET floats whatever the matrices take
  const int smem = (BUDGET + MISC) * 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p <= 32) return launch<32, 8, 4>(g, B, smem, st);
  if (p <= 64) return launch<64, 8, 8>(g, B, smem, st);
  return launch<128, 8, 16>(g, B, smem, st);
}

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
