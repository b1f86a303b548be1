// K6: the zip-up and truncation sweep of one boundary-MPS row absorption
// (everything bmps.compress_apply does before the polish), every site of
// every lane on the card, one thread block per lane.
//
// Replaces, in the port, the three steps of bmps.compress_apply that
// precede the variational polish (tnax/bmps.py compress_apply, which XLA
// ran): canonize_right of the row's input MPS; zipup_apply of the row's
// traced tensors at bond 16, each site truncated by the randomized SVD
// bmps._rsvd (the shared Gaussian sketch of rank 48, two power
// iterations) and the keep rule bmps._keep_mask, with the exact discarded
// mass; and canonize_right(compress=True) back down to bond 8, then
// slice_bond. At the balancing ladder's shapes (bond 8, legs 16, up to 16
// sites) the plain versions launch some 1,050 kernels a site, each QR and
// SVD a cuSOLVER call per matrix, and svd_fixed's torch.linalg.svd reads
// its info on the host at every site.
//
// What bounds it on this card: per site and lane about 30 M FP32 FMA
// (the 128 x 256 x 256 product of T A with the site's traced tensor W,
// the sketch's six 256 x 128 x 48 products, five Householder QRs of
// 256 x 48 and 128 x 48 panels, a one-sided Jacobi SVD of 48 x 128), all
// of it a dependent chain from site to site. The design:
//   - one block of sixteen warps per lane runs all three steps; no host
//     read or sync between them, and a row is one launch;
//   - the site's 256 x 128 matrix Gm stays in shared memory (129 KB)
//     through the sketch: Y (256 x 48), Z (128 x 48) and T beside it;
//     the product's W (256 KB a site) streams in 16 KB chunks by
//     cp.async, double-buffered, with the chunk's slice of T A formed on
//     the fly beside it, into 8 x 8 register tiles;
//   - the QRs keep each column in one warp's registers, as LAPACK's
//     geqr2: one barrier a column; Q is formed from the stored
//     reflectors without one (org2r's product, a column a warp). Only
//     the sketch's span matters, so its QRs carry no sign rule; the
//     truncation sweep's carry qr_fixed's;
//   - the SVD of the 48 x 128 core Bm = Q^T Gm is one-sided Jacobi on the
//     48 columns of Bm^T, 24 disjoint round-robin pairs a round, a pair to
//     16 lanes, until a sweep rotates nothing (LAPACK sgesvj's tolerance,
//     sqrt(rows) eps, and its negligible columns): Bm^T V = U' S gives
//     Ub = V, and S Vh = U'^T needs no division;
//   - the zip-up's sites (16 KB each) go to a scratch tensor in device
//     memory for the right-to-left truncation sweep, whose 16 x 16 SVDs
//     run on the same Jacobi, 8 half warps a round.
// FP32 FMA throughout, no tensor cores: the configuration states float32.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "jacobi.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 512;            // sixteen warps
constexpr int NW = NT / 32;
constexpr int BD = 8;              // the row's bond
constexpr int LEG = 16;            // the physical and MPO legs
constexpr int DZ = 2 * BD;         // the zip-up's bond
constexpr int KS = DZ + 32;        // the sketch's rank
constexpr int GR = DZ * LEG;       // rows of a site's Gm: (m, u)
constexpr int GC = BD * LEG;       // its columns: (b, r)
constexpr int LMAX = 16;
constexpr int SITE = BD * LEG * BD;     // a site of the row: 1024
constexpr int ZSITE = DZ * LEG * DZ;    // a site of the zip-up: 4096

// strides of the shared matrices, odd so that a row or a column read by
// consecutive lanes falls on distinct banks
constexpr int GS = GC + 1;         // Gm, row-major
constexpr int YS = GR + 1;         // Y and Q, column-major
constexpr int ZS = GC + 1;         // the sketch, Z and Bm^T, column-major
constexpr int VS = KS + 1;         // the Jacobi rotations, column-major

// shared memory, in floats
constexpr int OFF_G = 0;                       // Gm; before it the W
                                               // chunks, the T A slices
                                               // and phi; after it V
constexpr int OFF_Y = OFF_G + GR * GS;
constexpr int OFF_Z = OFF_Y + KS * YS;
constexpr int OFF_T = OFF_Z + KS * ZS;         // T (16, 8, 16)
constexpr int OFF_MISC = OFF_T + DZ * GC;
constexpr int SMEM_FLOATS = OFF_MISC + 256;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
// the G region while the product runs
constexpr int OFF_WB = OFF_G;                  // two W chunks
constexpr int OFF_XB = OFF_WB + 2 * LEG * GR;  // two slices of T A
constexpr int OFF_PH = OFF_XB + 2 * LEG * GC;  // the site's phi
// OFF_MISC: the reflectors' tau and beta, a block reduction's partials,
// the singular values, their order, the kept columns' signs and squares,
// a scalar
constexpr int M_TAU = 0, M_BETA = 48, M_RED = 96, M_S = 112, M_ORD = 160,
              M_COEF = 208, M_KEPT = 224, M_SCAL = 240;

struct Args {
  const float* A;       // the row's input MPS (B, L, 8, 16, 8), any strides
  long long a_b, a_n, a_0, a_1, a_2;
  const float* ln_in;   // its lognorm (B,)
  long long ln_s;
  const float* W;       // (B, L, 16, 16, 16, 16), each site contiguous
  long long w_b, w_n;
  const float* om;      // the sketch (L, 128, 48), contiguous
  float* phi;           // the canonized input (B, L, 8, 16, 8)
  float* phi_ln;        // (B,)
  float* A0;            // the truncated zip-up (B, L, 8, 16, 8)
  float* disc;          // (B,)
  float* scratch;       // the zip-up's sites (B, L, 256, 16)
  int L;
  float tol_zip, tol_trunc;
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

// sums of K values over the warp at once; every lane gets the same bits
template <int K>
__device__ __forceinline__ void warp_sum_n(float (&v)[K]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(FULL, v[k], o);
}

// over the sixteen lanes of a half warp
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float half_min(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
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

// bmps.nfactor as an exponent: the largest |entry| floored to a power of
// two, 1 (exponent 0) for zero
__device__ __forceinline__ int nf_exp(float mx) {
  return mx > 0.f ? ilogbf(mx) : 0;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// round-robin pairs of n = n1 + 1 columns (n1 odd): round r pairs column
// n1 with r and (r + k) % n1 with (r - k) % n1, k = 1 .. n / 2 - 1
__host__ __device__ constexpr int rr_p(int n1, int r, int k) {
  return k == 0 ? r
                : ((r + k) % n1 < (r - k + n1) % n1 ? (r + k) % n1
                                                    : (r - k + n1) % n1);
}
__host__ __device__ constexpr int rr_q(int n1, int r, int k) {
  return k == 0 ? n1
                : ((r + k) % n1 < (r - k + n1) % n1 ? (r - k + n1) % n1
                                                    : (r + k) % n1);
}

// ---- Householder QR -------------------------------------------------------

// the column of warp w's slot s (slots zigzag, so that forming Q costs
// every warp about the same)
__device__ __forceinline__ int col_of(int w, int s) {
  return s == 1 ? 31 - w : 16 * s + w;
}

// slarfg on column j of a panel, held in the owning warp's registers x
// (rows lane + 32 i): the reflector v (v[j] = 1, zeros above) into v,
// tau and beta into shared memory; x becomes R's column (beta at row j,
// zeros below)
template <int RPL>
__device__ __forceinline__ void reflector(float (&x)[RPL], int j, float* v,
                                          float* tauS, float* betaS,
                                          int lane) {
  float xa = 0.f;
#pragma unroll
  for (int i = 0; i < RPL; ++i)
    if (i == (j >> 5)) xa = x[i];
  const float alpha = __shfl_sync(FULL, xa, j & 31);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < RPL; ++i)
    if (lane + 32 * i > j) ss = fmaf(x[i], x[i], ss);
  ss = warp_sum(ss);
  const float all2 = fmaf(alpha, alpha, ss);
  // the column below the diagonal and alpha, scaled by 2^-e where a
  // square would underflow or overflow (slarfg's rescaling; v and tau do
  // not depend on the scale, beta is scaled back)
  int e = 0;
  bool some = ss >= 1e-30f && all2 <= 1e30f;
  if (!some) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < RPL; ++i)
      if (lane + 32 * i > j) amax = fmaxf(amax, fabsf(x[i]));
    amax = warp_max(amax);
    some = amax > 0.f;
    if (some) {
      e = ilogbf(fmaxf(amax, fabsf(alpha)));
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        if (lane + 32 * i > j) {
          const float y = ldexpf(x[i], -e);
          ss = fmaf(y, y, ss);
        }
      ss = warp_sum(ss);
    }
  }
  float tau = 0.f, beta = alpha, scal = 0.f;
  if (some) {
    const float as = e ? ldexpf(alpha, -e) : alpha;
    const float mag = sqrtf(fmaf(as, as, ss));
    const float bs = as >= 0.f ? -mag : mag;
    tau = (bs - as) / bs;
    scal = 1.f / (as - bs);
    beta = e ? ldexpf(bs, e) : bs;
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int row = lane + 32 * i;
    const float xs = e ? ldexpf(x[i], -e) : x[i];
    v[row] = row < j ? 0.f : (row == j ? 1.f : xs * scal);
    if (row == j)
      x[i] = beta;
    else if (row > j)
      x[i] = 0.f;
  }
  if (lane == 0) {
    tauS[j] = tau;
    betaS[j] = beta;
  }
}

// The Householder QR of the M x N panel P (column-major, column stride
// M + 1) as LAPACK's geqr2 then org2r; P gets Q (M x N). Column c lives in
// the registers of the warp whose slot holds it: one barrier a column.
// With FIX, qr_fixed's rule (column c of Q and row c of R times the sign
// of R[c, c], 1 where it is 0) and R (N x N, row-major) into Rout.
template <int M, int N, bool FIX>
__device__ void householder(float* P, float* Rout, float* misc, int t) {
  constexpr int RPL = M / 32, NS = (N + 15) / 16, PS = M + 1;
  float* tauS = misc + M_TAU;
  float* betaS = misc + M_BETA;
  const int w = t >> 5, lane = t & 31;
  float x[NS][RPL];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int c = col_of(w, s);
#pragma unroll
    for (int i = 0; i < RPL; ++i)
      x[s][i] = c < N ? P[c * PS + lane + 32 * i] : 0.f;
  }
  __syncthreads();  // P now takes the reflectors
  for (int j = 0; j < N; ++j) {
    int own = -1;  // the slot holding column j, if this warp's
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (col_of(w, s) == j) own = s;
    if (own >= 0) {
      // through a copy, so that x is only ever indexed statically
      float xc[RPL];
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        xc[i] = x[0][i];
#pragma unroll
        for (int s = 1; s < NS; ++s)
          if (own == s) xc[i] = x[s][i];
      }
      reflector<RPL>(xc, j, P + j * PS, tauS, betaS, lane);
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (own == s)
#pragma unroll
          for (int i = 0; i < RPL; ++i) x[s][i] = xc[i];
    }
    __syncthreads();
    const float tau = tauS[j];
    if (tau != 0.f) {
      float v[RPL], dot[NS];
#pragma unroll
      for (int i = 0; i < RPL; ++i) v[i] = P[j * PS + lane + 32 * i];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        dot[s] = 0.f;
        const int c = col_of(w, s);
        if (c > j && c < N)
#pragma unroll
          for (int i = 0; i < RPL; ++i) dot[s] = fmaf(v[i], x[s][i], dot[s]);
      }
      warp_sum_n<NS>(dot);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int c = col_of(w, s);
        if (c > j && c < N) {
          const float f = tau * dot[s];
#pragma unroll
          for (int i = 0; i < RPL; ++i) x[s][i] = fmaf(-f, v[i], x[s][i]);
        }
      }
    }
  }
  // Q's column c: H_c, then H_{c-1}, ..., H_0 applied to e_c (H_j e_c =
  // e_c for j > c)
  int cmax = -1;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (col_of(w, s) < N) cmax = max(cmax, col_of(w, s));
  float q[NS][RPL];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < RPL; ++i)
      q[s][i] = lane + 32 * i == col_of(w, s) ? 1.f : 0.f;
  for (int j = cmax; j >= 0; --j) {
    const float tau = tauS[j];
    if (tau == 0.f) continue;
    float v[RPL], dot[NS];
#pragma unroll
    for (int i = 0; i < RPL; ++i) v[i] = P[j * PS + lane + 32 * i];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      dot[s] = 0.f;
      const int c = col_of(w, s);
      if (j <= c && c < N)
#pragma unroll
        for (int i = 0; i < RPL; ++i) dot[s] = fmaf(v[i], q[s][i], dot[s]);
    }
    warp_sum_n<NS>(dot);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int c = col_of(w, s);
      if (j <= c && c < N) {
        const float f = tau * dot[s];
#pragma unroll
        for (int i = 0; i < RPL; ++i) q[s][i] = fmaf(-f, v[i], q[s][i]);
      }
    }
  }
  if (FIX) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int c = col_of(w, s);
      if (c < N) {
        const float sc = betaS[c] < 0.f ? -1.f : 1.f;
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          q[s][i] *= sc;
          const int row = lane + 32 * i;
          if (row < N)
            Rout[row * N + c] =
                row <= c ? x[s][i] * (betaS[row] < 0.f ? -1.f : 1.f) : 0.f;
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the reflectors
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int c = col_of(w, s);
    if (c < N)
#pragma unroll
      for (int i = 0; i < RPL; ++i) P[c * PS + lane + 32 * i] = q[s][i];
  }
  __syncthreads();
}

// ---- the site's product and the sketch's products -------------------------

// W's chunk l, rows (d) by columns (r, u) of the site's W[l, d, r, u]: a
// contiguous 16 KB
__device__ __forceinline__ void load_w_chunk(float* buf, const float* Wn,
                                             int l, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = t + NT * i;  // a float4 of the chunk
    cp_async16(buf + 4 * q, Wn + l * LEG * GR + 4 * q);
  }
  cp_async_commit();
}

// the slice l of T A: X[d, (m, b)] = sum_a T[m, a, l] phi[a, d, b]
__device__ __forceinline__ void ta_slice(const float* T, const float* ph,
                                         float* X, int l, int t) {
  const int row = t & 127, m = row >> 3, b = row & 7, d0 = (t >> 7) * 4;
  float tv[BD];
#pragma unroll
  for (int a = 0; a < BD; ++a) tv[a] = T[m * GC + a * LEG + l];
#pragma unroll
  for (int dd = 0; dd < 4; ++dd) {
    const int d = d0 + dd;
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < BD; ++a) s = fmaf(tv[a], ph[a * 128 + d * 8 + b], s);
    X[d * GC + row] = s;
  }
}

// Gm[(m, u), (b, r)] = sum_{l, d} (T A)[m, l, d, b] W[l, d, r, u]: the
// product (m, b) x (r, u) over sixteen chunks of l, W's chunk 0 and the
// slice 0 of T A already in place. Warp (wr, wc) takes rows 32 wr .. + 31
// and columns 64 wc .. + 63; a thread eight rows (two runs of four) by
// eight columns (likewise). Returns the sum of Gm's squares.
__device__ float site_product(float* sm, const float* Wn, int t) {
  float* WB = sm + OFF_WB;
  float* XB = sm + OFF_XB;
  const float* PH = sm + OFF_PH;
  const float* T = sm + OFF_T;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = (warp >> 2) * 32 + (lane >> 3) * 4;
  const int c0 = (warp & 3) * 64 + (lane & 7) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int l = 0; l < LEG; ++l) {
    cp_async_wait_all();
    __syncthreads();  // chunk l landed; every warp is done with l - 1
    if (l + 1 < LEG) {
      load_w_chunk(WB + ((l + 1) & 1) * LEG * GR, Wn, l + 1, t);
      ta_slice(T, PH, XB + ((l + 1) & 1) * LEG * GC, l + 1, t);
    }
    const float* wb = WB + (l & 1) * LEG * GR;
    const float* xk = XB + (l & 1) * LEG * GC;
#pragma unroll 4
    for (int kk = 0; kk < LEG; ++kk) {
      const float4 xa = *reinterpret_cast<const float4*>(xk + kk * GC + r0);
      const float4 xb =
          *reinterpret_cast<const float4*>(xk + kk * GC + r0 + 16);
      const float4 wa = *reinterpret_cast<const float4*>(wb + kk * GR + c0);
      const float4 wv =
          *reinterpret_cast<const float4*>(wb + kk * GR + c0 + 32);
      const float xs[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xs[i], ws[j], acc[i][j]);
    }
  }
  __syncthreads();  // every warp is done with the chunks
  float* G = sm + OFF_G;
  float f2 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i < 4 ? i : 12 + i), m = row >> 3, b = row & 7;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? j : 28 + j), r = col >> 4, u = col & 15;
      G[(m * LEG + u) * GS + b * LEG + r] = acc[i][j];
      f2 = fmaf(acc[i][j], acc[i][j], f2);
    }
  }
  return block_sum(f2, sm + OFF_MISC + M_RED, t);
}

// Y (256 x 48) = Gm X, X (128 x 48) column-major in the Z region: a
// thread rows rq + 64 ii by columns 6 cq .. + 5
__device__ void gemm_gx(const float* G, const float* X, float* Y, int t) {
  const int cq = t & 7, rq = t >> 3;
  float acc[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < GC; ++k) {
    float a[4], b[6];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = G[(rq + 64 * i) * GS + k];
#pragma unroll
    for (int j = 0; j < 6; ++j) b[j] = X[(6 * cq + j) * ZS + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) Y[(6 * cq + j) * YS + rq + 64 * i] = acc[i][j];
}

// Z (128 x 48) = Gm^T Q, Q (256 x 48) column-major in the Y region: a
// thread rows rr and rr + 64 by columns 6 cq .. + 5
__device__ void gemm_gtq(const float* G, const float* Q, float* Z, int t) {
  const int cq = t & 7, rr = t >> 3;
  float acc[2][6];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < GR; ++k) {
    const float a0 = G[k * GS + rr], a1 = G[k * GS + rr + 64];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float b = Q[(6 * cq + j) * YS + k];
      acc[0][j] = fmaf(a0, b, acc[0][j]);
      acc[1][j] = fmaf(a1, b, acc[1][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) Z[(6 * cq + j) * ZS + rr + 64 * i] = acc[i][j];
}

// ---- the SVDs --------------------------------------------------------------

// the Jacobi SVDs' convergence tolerances: sqrt(rows) eps
constexpr float JTOL48 = 11.3137085f * FLT_EPSILON;  // Bm^T: 128 rows
constexpr float JTOL16 = 4.f * FLT_EPSILON;          // Craw: 16 rows

// One-sided Jacobi (Hestenes) on the NC columns of X (16 RPL rows,
// column stride xs), the rotations accumulated in V (NC x NC, column
// stride vs, from the identity): a round's NC / 2 disjoint round-robin
// pairs go to as many half warps (rows i + 16 e to lane i), one barrier a
// round; sweeps until one rotates nothing, at most 30; columns below 8 eps
// of X's norm are not rotated (jacobi_rotation, csrc/jacobi.cuh) and keep
// their norms as their singular values. Then X V has orthogonal
// columns, and X = (X V) V^T. X must be in place when it is called.
template <int NC, int RPL>
__device__ void jacobi(float* X, int xs, float* V, int vs, float tol,
                       float* red, int t) {
  constexpr int NR = 16 * RPL, VPL = NC / 16;
  const int h = t >> 4, i = t & 15;
  float f2 = 0.f;
  for (int k = t; k < NC * vs; k += NT) V[k] = k % vs == k / vs ? 1.f : 0.f;
  for (int k = t; k < NC * NR; k += NT) {
    const float x = X[(k / NR) * xs + k % NR];
    f2 = fmaf(x, x, f2);
  }
  const float floor2 =
      64.f * FLT_EPSILON * FLT_EPSILON * block_sum(f2, red, t);
  for (int sweep = 0; sweep < 30; ++sweep) {
    int rotated = 0;
    for (int r = 0; r < NC - 1; ++r) {
      if (h < NC / 2) {
        const int p = rr_p(NC - 1, r, h), q = rr_q(NC - 1, r, h);
        float* bp = X + p * xs;
        float* bq = X + q * xs;
        float xp[RPL], xq[RPL];
        float al = 0.f, be = 0.f, ga = 0.f;
#pragma unroll
        for (int e = 0; e < RPL; ++e) {
          xp[e] = bp[i + 16 * e];
          xq[e] = bq[i + 16 * e];
          al = fmaf(xp[e], xp[e], al);
          be = fmaf(xq[e], xq[e], be);
          ga = fmaf(xp[e], xq[e], ga);
        }
        al = half_sum(al);
        be = half_sum(be);
        ga = half_sum(ga);
        float cs, sn, tn;
        if (jacobi_rotation(al, be, ga, tol, floor2, cs, sn, tn)) {
#pragma unroll
          for (int e = 0; e < RPL; ++e) {
            bp[i + 16 * e] = cs * xp[e] - sn * xq[e];
            bq[i + 16 * e] = sn * xp[e] + cs * xq[e];
          }
          float* vp = V + p * vs;
          float* vq = V + q * vs;
#pragma unroll
          for (int e = 0; e < VPL; ++e) {
            const float a = vp[i + 16 * e], b = vq[i + 16 * e];
            vp[i + 16 * e] = cs * a - sn * b;
            vq[i + 16 * e] = sn * a + cs * b;
          }
          rotated = 1;
        }
      }
      __syncthreads();
    }
    if (!__syncthreads_or(rotated)) break;
  }
}

// The truncation step of one site of canonize_right(compress=True): the
// SVD of Craw = R^T / 2^e (R 16 x 16 row-major) by jacobi on its 16
// columns (Wj gets Craw V, Vj V, column-major, stride 17), then in warp 0
// svd_fixed's signs and the keep rule (at most BD singular values above
// tol times the largest); writes the kept rows of Vh (BD x 16) into Vh,
// the next C = U S (16 x 16, row-major) into Cn and the discarded weight
// (bmps.truncate_center's) into misc[M_SCAL].
__device__ void truncate16(const float* R, int e, float* Wj, float* Vj,
                           float* Vh, float* Cn, float* misc, float tol,
                           int t) {
  // column c of Craw is row c of R
  if (t < 256) Wj[(t >> 4) * 17 + (t & 15)] = ldexpf(R[t], -e);
  __syncthreads();
  jacobi<16, 1>(Wj, 17, Vj, 17, JTOL16, misc + M_RED, t);
  if (t >= 32) return;
  const int lane = t;
  // Craw V = W: U = W / S, Vh = V^T; column k's norm and svd_fixed's
  // flip (the column of U and the row of Vh both mostly negative)
  float* S = misc + M_S;
  float* flip = misc + M_COEF;
  int* ord = reinterpret_cast<int*>(misc + M_ORD);
  if (lane < 16) {
    float ss = 0.f, umin = INFINITY, umax = -INFINITY, vmin = INFINITY,
          vmax = -INFINITY;
    for (int r = 0; r < 16; ++r) {
      const float w = Wj[lane * 17 + r], x = Vj[lane * 17 + r];
      ss = fmaf(w, w, ss);
      umin = fminf(umin, w);
      umax = fmaxf(umax, w);
      vmin = fminf(vmin, x);
      vmax = fmaxf(vmax, x);
    }
    S[lane] = sqrtf(ss);
    flip[lane] = fabsf(umin) > umax && fabsf(vmin) > vmax ? -1.f : 1.f;
  }
  __syncwarp();
  if (lane < 16) {
    const float s = S[lane];
    int rank = 0;
    for (int k = 0; k < 16; ++k)
      rank += S[k] > s || (S[k] == s && k < lane);
    ord[rank] = lane;
  }
  __syncwarp();
  const float s0 = S[ord[0]];
  float dsq = 0.f;
  if (lane < 16) {
    const int j = ord[lane];
    const float sj = S[j];
    const bool keep = lane < BD && sj > s0 * tol;
    const float cf = keep ? flip[j] : 0.f;
    for (int r = 0; r < 16; ++r) Cn[r * 16 + lane] = cf * Wj[j * 17 + r];
    if (lane < BD)
      for (int b = 0; b < 16; ++b) Vh[lane * 16 + b] = cf * Vj[j * 17 + b];
    dsq = keep ? 0.f : sj * sj;
  }
  dsq = warp_sum(dsq);
  if (lane == 0) misc[M_SCAL] = sqrtf(dsq) / (s0 > 0.f ? s0 : 1.f);
  __syncwarp();
}

// ---- the kernel ------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1) zipup_kernel(const Args g) {
  extern __shared__ float4 zipup_smem[];
  float* sm = reinterpret_cast<float*>(zipup_smem);
  float* misc = sm + OFF_MISC;
  float* red = misc + M_RED;
  const int t = threadIdx.x, z = blockIdx.x, L = g.L;

  // 1. canonize_right of the input, sites L - 1 .. 0: M[(d, c), a] =
  // sum_b A[a, d, b] C[b, c], its QR (qr_fixed), R / nfactor(R) and
  // C = R^T; phi's site is Q^T, the last one times the sign of the
  // final scalar
  float ln = g.ln_in[z * g.ln_s];
  {
    float* Ain = sm;
    float* C = sm + SITE;
    float* R = C + BD * BD;
    float* P = sm + 2 * SITE;  // 128 x 8, column stride 129
    if (t < BD * BD) C[t] = t == 0 ? 1.f : 0.f;
    for (int n = L - 1; n >= 0; --n) {
      const float* an = g.A + z * g.a_b + n * g.a_n;
      for (int k = t; k < SITE; k += NT) {
        const int a = k >> 7, d = (k >> 3) & 15, b = k & 7;
        Ain[k] = an[a * g.a_0 + d * g.a_1 + b * g.a_2];
      }
      __syncthreads();
      for (int k = t; k < SITE; k += NT) {
        const int a = k >> 7, dc = k & 127, c = k & 7;
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < BD; ++b)
          s = fmaf(Ain[a * 128 + (dc & ~7) + b], C[b * BD + c], s);
        P[a * 129 + dc] = s;
      }
      __syncthreads();
      householder<128, BD, true>(P, R, misc, t);
      float mx = t < BD * BD ? fabsf(R[t]) : 0.f;
      const int e = nf_exp(block_max(mx, red, t));
      ln += static_cast<float>(e);
      if (t < BD * BD) C[t] = ldexpf(R[(t & 7) * BD + (t >> 3)], -e);
      __syncthreads();
      float sg = 1.f;
      if (n == 0) {
        const float c = C[0], mag = fabsf(c);
        if (mag > 0.f) ln += log2f(mag);
        sg = c < 0.f ? -1.f : 1.f;
      }
      float* out = g.phi + (static_cast<long long>(z) * L + n) * SITE;
      for (int k = t; k < SITE; k += NT)
        out[k] = P[(k >> 7) * 129 + (k & 127)] * sg;
      __syncthreads();
    }
    if (t == 0) g.phi_ln[z] = ln;
  }

  // 2. the zip-up at bond 16, sites 0 .. L - 1: Gm = (T phi) W, its
  // randomized SVD (Y = Gm Omega, then twice Z = Gm^T Q, Y = Gm Z, a QR
  // after each), the core Bm = Q^T Gm's SVD, the keep rule at tol_zip;
  // the site's U = Q Ub to the scratch, T = S Vh / nfactor
  float* G = sm + OFF_G;
  float* Y = sm + OFF_Y;
  float* Z = sm + OFF_Z;
  float* T = sm + OFF_T;
  float* V = sm + OFF_G;  // the Jacobi rotations, once Gm is done with
  float* S = misc + M_S;
  int* ord = reinterpret_cast<int*>(misc + M_ORD);
  float* coef = misc + M_COEF;
  float* kept = misc + M_KEPT;
  for (int k = t; k < DZ * GC; k += NT) T[k] = k == 0 ? 1.f : 0.f;
  float disc = 0.f;
  for (int n = 0; n < L; ++n) {
    const float* Wn = g.W + z * g.w_b + n * g.w_n;
    load_w_chunk(sm + OFF_WB, Wn, 0, t);
    const float* pn = g.phi + (static_cast<long long>(z) * L + n) * SITE;
    for (int k = t; k < SITE; k += NT) sm[OFF_PH + k] = pn[k];
    __syncthreads();
    ta_slice(T, sm + OFF_PH, sm + OFF_XB, 0, t);
    const float frob2 = site_product(sm, Wn, t);
    const float* om = g.om + static_cast<long long>(n) * GC * KS;
    for (int k = t; k < GC * KS; k += NT) Z[(k % KS) * ZS + k / KS] = om[k];
    __syncthreads();
    gemm_gx(G, Z, Y, t);
    __syncthreads();
    householder<GR, KS, false>(Y, nullptr, misc, t);
    for (int it = 0; it < 2; ++it) {
      gemm_gtq(G, Y, Z, t);
      __syncthreads();
      householder<GC, KS, false>(Z, nullptr, misc, t);
      gemm_gx(G, Z, Y, t);
      __syncthreads();
      householder<GR, KS, false>(Y, nullptr, misc, t);
    }
    gemm_gtq(G, Y, Z, t);  // Bm^T
    __syncthreads();
    jacobi<KS, 8>(Z, ZS, V, VS, JTOL48, red, t);
    // singular values (the columns' norms), their descending order
    {
      const int h = t >> 4, i = t & 15;
      for (int j = h; j < KS; j += 32) {
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = Z[j * ZS + i + 16 * e];
          ss = fmaf(x, x, ss);
        }
        ss = half_sum(ss);
        if (i == 0) S[j] = sqrtf(ss);
      }
    }
    __syncthreads();
    if (t < KS) {
      const float s = S[t];
      int rank = 0;
      for (int k = 0; k < KS; ++k) rank += S[k] > s || (S[k] == s && k < t);
      ord[rank] = t;
    }
    __syncthreads();
    // the 16 largest: the keep rule and svd_fixed's flip (the column of
    // Ub and the row of Vh both mostly negative), a half warp each
    {
      const int h = t >> 4, i = t & 15;
      if (h < DZ) {
        const int j = ord[h];
        const float sj = S[j];
        float umin = INFINITY, umax = -INFINITY, vmin = INFINITY,
              vmax = -INFINITY;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float x = V[j * VS + i + 16 * e];
          umin = fminf(umin, x);
          umax = fmaxf(umax, x);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = Z[j * ZS + i + 16 * e];
          vmin = fminf(vmin, x);
          vmax = fmaxf(vmax, x);
        }
        umin = half_min(umin);
        umax = half_max(umax);
        vmin = half_min(vmin);
        vmax = half_max(vmax);
        const bool keep = sj > S[ord[0]] * g.tol_zip;
        const bool flip = fabsf(umin) > umax && fabsf(vmin) > vmax;
        if (i == 0) {
          coef[h] = keep ? (flip ? -1.f : 1.f) : 0.f;
          kept[h] = keep ? sj * sj : 0.f;
        }
      }
    }
    __syncthreads();
    {
      float kept2 = 0.f;
#pragma unroll
      for (int k = 0; k < DZ; ++k) kept2 += kept[k];
      const float s0 = S[ord[0]];
      disc = fmaxf(disc, sqrtf(fmaxf(frob2 - kept2, 0.f)) /
                             (s0 > 0.f ? s0 : 1.f));
    }
    // the site: U[(m, u), k] = coef_k sum_j Q[(m, u), j] V[j, ord_k]
    {
      const int row = t >> 1, k0 = (t & 1) * 8;
      int oj[8];
      float cf[8], acc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        oj[k] = ord[k0 + k] * VS;
        cf[k] = coef[k0 + k];
        acc[k] = 0.f;
      }
      for (int j = 0; j < KS; ++j) {
        const float qv = Y[j * YS + row];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(qv, V[oj[k] + j], acc[k]);
      }
      float4* dst = reinterpret_cast<float4*>(
          g.scratch +
          ((static_cast<long long>(z) * L + n) * GR + row) * DZ + k0);
      dst[0] = make_float4(acc[0] * cf[0], acc[1] * cf[1], acc[2] * cf[2],
                           acc[3] * cf[3]);
      dst[1] = make_float4(acc[4] * cf[4], acc[5] * cf[5], acc[6] * cf[6],
                           acc[7] * cf[7]);
    }
    // the next T = S Vh's first 16 rows = coef_k Bt[:, ord_k], divided
    // by its nfactor
    float mx = 0.f;
    for (int k = t; k < DZ * GC; k += NT) {
      const float x = coef[k >> 7] * Z[ord[k >> 7] * ZS + (k & 127)];
      T[k] = x;
      mx = fmaxf(mx, fabsf(x));
    }
    const int e = nf_exp(block_max(mx, red, t));
    for (int k = t; k < DZ * GC; k += NT) T[k] = ldexpf(T[k], -e);
    __syncthreads();
  }
  // the final scalar's sign goes on the zip-up's last site
  const float sgz = T[0] < 0.f ? -1.f : 1.f;

  // 3. canonize_right(compress=True, cap=8) of the zip-up, sites L - 1 ..
  // 0: M[(d, c), a] = sum_b U[a, d, b] C[b, c], its QR (qr_fixed), R /
  // nfactor(R), the SVD of Craw = R^T truncated to at most 8; the new
  // site Vh Q^T sliced to bond 8, C = U S; the last site times the sign
  // of the final scalar
  {
    float* site = sm;                  // (16, 16, 16)
    float* C = sm + ZSITE;             // 16 x 16
    float* R = C + 256;
    float* Wj = R + 256;               // 16 x 17
    float* Vj = Wj + 272;              // 16 x 17
    float* Vh = Vj + 272;              // 8 x 16
    float* Cn = Vh + 128;              // 16 x 16
    float* P = sm + 2 * ZSITE;         // 256 x 16, column stride 257
    if (t < 256) C[t] = t == 0 ? 1.f : 0.f;
    for (int n = L - 1; n >= 0; --n) {
      const float* src =
          g.scratch + (static_cast<long long>(z) * L + n) * ZSITE;
      const float sg = n == L - 1 ? sgz : 1.f;
      for (int k = t; k < ZSITE; k += NT) site[k] = src[k] * sg;
      __syncthreads();
      for (int k = t; k < ZSITE; k += NT) {
        const int a = k >> 8, dc = k & 255, c = k & 15;
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < DZ; ++b)
          s = fmaf(site[a * 256 + (dc & ~15) + b], C[b * 16 + c], s);
        P[a * 257 + dc] = s;
      }
      __syncthreads();
      householder<GR, DZ, true>(P, R, misc, t);
      const float mx = t < 256 ? fabsf(R[t]) : 0.f;
      const int e = nf_exp(block_max(mx, red, t));
      truncate16(R, e, Wj, Vj, Vh, Cn, misc, g.tol_trunc, t);
      __syncthreads();
      disc = fmaxf(disc, misc[M_SCAL]);
      const float s0 = n == 0 ? (Cn[0] < 0.f ? -1.f : 1.f) : 1.f;
      float* dst = g.A0 + (static_cast<long long>(z) * L + n) * SITE;
      for (int k = t; k < SITE; k += NT) {
        const int kr = k >> 7, d = (k >> 3) & 15, c = k & 7;
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < DZ; ++b)
          s = fmaf(Vh[kr * 16 + b], P[b * 257 + d * 16 + c], s);
        dst[k] = s * s0;
      }
      if (t < 256) C[t] = Cn[t];
      __syncthreads();
    }
  }
  if (t == 0) g.disc[z] = disc;
}

// ---- host side: the launch

}  // namespace

extern "C" {

int tnax_zipup_f32(const void* A, long long a_b, long long a_n,
                   long long a_0, long long a_1, long long a_2,
                   const void* ln_in, long long ln_s, const void* W,
                   long long w_b, long long w_n, const void* om, int B, int L,
                   double tol_zip, double tol_trunc, void* phi, void* phi_ln,
                   void* A0, void* disc, void* scratch, void* stream) {
  if (B < 0 || L < 1 || L > LMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        zipup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const Args g{static_cast<const float*>(A), a_b, a_n, a_0, a_1, a_2,
               static_cast<const float*>(ln_in), ln_s,
               static_cast<const float*>(W), w_b, w_n,
               static_cast<const float*>(om), static_cast<float*>(phi),
               static_cast<float*>(phi_ln), static_cast<float*>(A0),
               static_cast<float*>(disc), static_cast<float*>(scratch), L,
               static_cast<float>(tol_zip), static_cast<float>(tol_trunc)};
  zipup_kernel<<<B, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
