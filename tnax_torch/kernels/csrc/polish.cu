// K5: the variational polish of one boundary-MPS row absorption, every
// pass of every lane on the card, one thread block per lane.
//
// Replaces the polish of tnax/bmps.py `variational_implicit` (its
// lax.while_loop of alternating one-site sweeps, which XLA ran) and, in
// the port, the host loop of bmps.variational_implicit_plain with
// bmps._alternate: left environments of the zip-up output, then passes
// of a right and a left sweep until each lane's Schmidt-vector change is
// at most tol, or it has run max_sweeps, or (float32) a pass no longer
// shrinks the change by 10%. Per site step: the projection of the
// implicit target phi o W onto the MPS, LAPACK's Householder QR of the
// 128 x 8 matrix with diag(R) >= 0 (a zero column gives tau = 0 and a
// unit-vector column of Q, as geqrf/orgqr do), the singular values of R
// divided by the largest, and the environment update with a power-of-two
// rescale whose log2 the left chain keeps.
//
// What bounds it on this card: at the ladder's shapes (bonds 8, legs 16)
// a site step is one 64 x 256 x 256 product against the site's traced
// tensor W (4.2 M FMA), plus four 131 k FMA contractions, a 128 x 8 QR
// and an 8 x 8 SVD; a chimera-2048 row of 16 sites runs some 245 steps.
// The work is a few milliseconds of the card's FP32 rate, but the chain
// of steps is serial and each QR and SVD is a dependent chain of
// reductions. The plain version launches some hundred kernels a step and
// calls svdvals, which synchronizes the card with the host, 31 times a
// pass. The design:
//   - one block of eight warps per lane runs the whole polish: the stop
//     rule is applied on the card, a stopped lane simply ends (what the
//     host loop's keep_old gives), and the host never waits;
//   - a lane's L + 1 environments (4 KB each, L <= 16) live in shared
//     memory for the whole polish; a right-sweep environment takes the
//     slot of the left one it replaces;
//   - the product runs from shared memory in 8 x 8 register tiles per
//     thread, W streamed from L2 (a row's W is 4 MB a lane) in 16 KB
//     chunks by cp.async, double-buffered; each sweep direction shares
//     one product between the projection and the environment update
//     (left: (FL phi) W; right: (phi FR) W), so a site step does one;
//   - the QR keeps column c in warp c's registers: eight steps, one
//     barrier each; Q is formed from the stored reflectors without one;
//   - the singular values only feed the stop rule, so each pass stores
//     its 2L - 1 R factors and takes them together at its end, eight
//     lanes a matrix (one-sided Jacobi, four disjoint column pairs a
//     round), off the chain of site steps.
// FP32 FMA throughout, no tensor cores: the configuration states float32.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;         // eight warps
constexpr int BD = 8;           // new and old bond
constexpr int LMAX = 16;        // sites
constexpr int ENV = 1024;       // an environment, a site tensor: 8 x 16 x 8
constexpr int CROW = 272;       // a row of C: 16 groups of 16, stride 17
constexpr int MS = 132;         // a column of the QR's 128 x 8 matrix
constexpr int NSTEP = 2 * LMAX - 1;

// shared memory, in floats
constexpr int OFF_XC = 0;                         // X (256 x 64), then C
constexpr int OFF_W = OFF_XC + 64 * CROW;         // two W chunks
constexpr int OFF_E = OFF_W + 2 * 16 * 256;       // L + 1 environments
constexpr int OFF_P = OFF_E + (LMAX + 1) * ENV;   // the site's phi
constexpr int OFF_M = OFF_P + ENV;                // the QR's input
constexpr int OFF_V = OFF_M + BD * MS;            // reflectors
constexpr int OFF_Q = OFF_V + BD * 128;           // Q, or A0's site
constexpr int OFF_R = OFF_Q + ENV;                // a pass's R factors
constexpr int OFF_S = OFF_R + NSTEP * 64;         // their singular values
constexpr int OFF_MISC = OFF_S + 256;
constexpr int SMEM_FLOATS = OFF_MISC + 64;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
// OFF_MISC: tau [0, 8), beta [8, 16), warp maxima [16, 24), the Schmidt
// values at the last bond [24, 32), the pass's change [32]

struct Args {
  const float* A0;    // (B, L, 8, 16, 8), any strides
  long long a_b, a_n, a_0, a_1, a_2;
  const float* phi;   // (B, L, 8, 16, 8), any strides
  long long p_b, p_n, p_0, p_1, p_2;
  const float* W;     // (B, L, 16, 16, 16, 16), each site contiguous
  long long w_b, w_n;
  float* A_out;       // (B, L, 8, 16, 8) contiguous
  float* overlap;     // (B,)
  float* ln_state;    // (B,)
  long long* sweeps;  // (B,)
  int L, max_sweeps;
  float tol;
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

// a sum over the eight lanes of a group (lanes 8g .. 8g + 7); every lane
// of the group gets the same bits
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
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

__device__ __forceinline__ bool going(float diff, float prev, int sweeps,
                                      float tol, int max_sweeps) {
  // bmps._alternate's rule with the float32 plateau stop
  return diff > tol && sweeps < max_sweeps &&
         (sweeps < 2 || diff < prev * 0.9f);
}

// K-rows 16c .. 16c + 15 of the site's W as a 256 x 256 matrix into buf:
// left, rows (l, d) and columns (r, u), a contiguous 16 KB; right, rows
// (d, r) and columns (l, u), sixteen 1 KB pieces
__device__ __forceinline__ void load_w_chunk(float* buf, const float* Wn,
                                             int c, bool right, int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = t + NT * i;  // a float4 of the chunk
    if (!right) {
      cp_async16(buf + 4 * q, Wn + c * 4096 + 4 * q);
    } else {
      const int l = q >> 6, r = (q >> 2) & 15, u4 = q & 3;
      cp_async16(buf + r * 256 + l * 16 + u4 * 4,
                 Wn + l * 4096 + c * 256 + (q & 63) * 4);
    }
  }
  cp_async_commit();
}

// a step's start: W's first chunk on its way, the site's phi (and A0's
// site tensor, for the first left environments) into shared memory
__device__ void begin_step(float* sm, const Args& g, int z, int n,
                           bool right, bool with_a0, int t) {
  load_w_chunk(sm + OFF_W, g.W + z * g.w_b + n * g.w_n, 0, right, t);
  const float* pn = g.phi + z * g.p_b + n * g.p_n;
  const float* an = g.A0 + z * g.a_b + n * g.a_n;
  for (int i = t; i < ENV; i += NT) {
    const int a = i >> 7, d = (i >> 3) & 15, b = i & 7;
    sm[OFF_P + i] = pn[a * g.p_0 + d * g.p_1 + b * g.p_2];
    if (with_a0) sm[OFF_Q + i] = an[a * g.a_0 + d * g.a_1 + b * g.a_2];
  }
  __syncthreads();
}

// left: X[(l, d), (m, b)] = sum_a FL[m, a, l] phi[a, d, b]; environments
// are stored (old, mpo, new): FL[m, a, l] at (a * 16 + l) * 8 + m
__device__ void x_left(float* sm, const float* FL, int t) {
  const float* p = sm + OFF_P;
  float* X = sm + OFF_XC;
  const int row = t & 63, m = row >> 3, b = row & 7, l0 = (t >> 6) * 4;
  float fl[4][8];
#pragma unroll
  for (int li = 0; li < 4; ++li)
#pragma unroll
    for (int a = 0; a < 8; ++a) fl[li][a] = FL[(a * 16 + l0 + li) * 8 + m];
  for (int d = 0; d < 16; ++d) {
    float pv[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) pv[a] = p[a * 128 + d * 8 + b];
#pragma unroll
    for (int li = 0; li < 4; ++li) {
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) s = fmaf(fl[li][a], pv[a], s);
      X[((l0 + li) * 16 + d) * 64 + row] = s;
    }
  }
}

// right: X[(d, r), (a, k)] = sum_b phi[a, d, b] FR[b, r, k]
__device__ void x_right(float* sm, const float* FR, int t) {
  const float* p = sm + OFF_P;
  float* X = sm + OFF_XC;
  const int row = t & 63, a = row >> 3, k = row & 7, d0 = (t >> 6) * 4;
  float pv[4][8];
#pragma unroll
  for (int di = 0; di < 4; ++di)
#pragma unroll
    for (int b = 0; b < 8; ++b) pv[di][b] = p[a * 128 + (d0 + di) * 8 + b];
  for (int r = 0; r < 16; ++r) {
    float fr[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) fr[b] = FR[(b * 16 + r) * 8 + k];
#pragma unroll
    for (int di = 0; di < 4; ++di) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < 8; ++b) s = fmaf(pv[di][b], fr[b], s);
      X[((d0 + di) * 16 + r) * 64 + row] = s;
    }
  }
}

// C (64 x 256) = X^T W: X K-major (256 x 64) in XC, W's chunk 0 already
// issued. C overwrites X: row stride CROW, column (h, u) at h * 17 + u.
// Warp (wr, wc) takes rows 32 wr .. + 31 and columns 64 wc .. + 63; a
// thread eight rows (two runs of four) by eight columns (likewise).
__device__ void gemm(float* sm, const float* Wn, bool right, int t) {
  float* X = sm + OFF_XC;
  float* Wb = sm + OFF_W;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = (warp >> 2) * 32 + (lane >> 3) * 4;
  const int c0 = (warp & 3) * 64 + (lane & 7) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < 16; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; every warp is done with c - 1
    if (c + 1 < 16)
      load_w_chunk(Wb + ((c + 1) & 1) * 4096, Wn, c + 1, right, t);
    const float* wb = Wb + (c & 1) * 4096;
    const float* xk = X + c * 16 * 64;
#pragma unroll 4
    for (int kk = 0; kk < 16; ++kk) {
      const float4 xa = *reinterpret_cast<const float4*>(xk + kk * 64 + r0);
      const float4 xb =
          *reinterpret_cast<const float4*>(xk + kk * 64 + r0 + 16);
      const float4 wa = *reinterpret_cast<const float4*>(wb + kk * 256 + c0);
      const float4 wv =
          *reinterpret_cast<const float4*>(wb + kk * 256 + c0 + 32);
      const float xs[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xs[i], ws[j], acc[i][j]);
    }
  }
  __syncthreads();  // every warp is done with X
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i < 4 ? i : 12 + i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? j : 28 + j);
      X[row * CROW + (col >> 4) * 17 + (col & 15)] = acc[i][j];
    }
  }
  __syncthreads();
}

// left projection B[m, u, k] = sum_{b, r} C[(m, b), (r, u)] FR[b, r, k]
// as the QR's matrix M[(m, u), k]: warp m, lane (u, half of k)
__device__ void proj_left(float* sm, const float* FR, int t) {
  const float* C = sm + OFF_XC;
  float* M = sm + OFF_M;
  const int m = t >> 5, u = t & 15, kh = (t >> 4) & 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b = 0; b < 8; ++b) {
    const float* cr = C + (m * 8 + b) * CROW + u;
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const float cv = cr[r * 17];
      const float4 f =
          *reinterpret_cast<const float4*>(FR + (b * 16 + r) * 8 + kh * 4);
      acc[0] = fmaf(cv, f.x, acc[0]);
      acc[1] = fmaf(cv, f.y, acc[1]);
      acc[2] = fmaf(cv, f.z, acc[2]);
      acc[3] = fmaf(cv, f.w, acc[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) M[(kh * 4 + j) * MS + m * 16 + u] = acc[j];
}

// right projection B[m, u, k] = sum_{a, l} FL[m, a, l] C[(a, k), (l, u)]
// as M[(u, k), m]: warp k, lane (u, half of m)
__device__ void proj_right(float* sm, const float* FL, int t) {
  const float* C = sm + OFF_XC;
  float* M = sm + OFF_M;
  const int k = t >> 5, u = t & 15, mh = (t >> 4) & 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int a = 0; a < 8; ++a) {
    const float* cr = C + (a * 8 + k) * CROW + u;
#pragma unroll 4
    for (int l = 0; l < 16; ++l) {
      const float cv = cr[l * 17];
      const float4 f =
          *reinterpret_cast<const float4*>(FL + (a * 16 + l) * 8 + mh * 4);
      acc[0] = fmaf(cv, f.x, acc[0]);
      acc[1] = fmaf(cv, f.y, acc[1]);
      acc[2] = fmaf(cv, f.z, acc[2]);
      acc[3] = fmaf(cv, f.w, acc[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) M[(mh * 4 + j) * MS + u * 8 + k] = acc[j];
}

// Householder QR of M (128 x 8), column c in warp c's registers (rows
// lane + 32 i), as LAPACK's geqr2 and org2r; then the signs of qr_fixed.
// Q[row * 8 + c] gets column c of Q, Rout (8 x 8, row-major) R.
__device__ void qr(float* sm, float* Rout, int t) {
  const float* M = sm + OFF_M;
  float* V = sm + OFF_V;
  float* Q = sm + OFF_Q;
  float* tauS = sm + OFF_MISC;
  float* betaS = sm + OFF_MISC + 8;
  const int w = t >> 5, lane = t & 31;
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = M[w * MS + lane + 32 * i];
  for (int j = 0; j < BD; ++j) {
    if (w == j) {
      // the reflector of column j: slarfg on x[j:]
      const float alpha = __shfl_sync(FULL, x[0], j);
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (lane + 32 * i > j) amax = fmaxf(amax, fabsf(x[i]));
      amax = warp_max(amax);
      float tau = 0.f, beta = alpha, scal = 0.f;
      if (amax > 0.f) {
        // the norm of a column scaled by a power of two, so that no
        // square underflows or overflows
        const int e = min(max(ilogbf(fmaxf(amax, fabsf(alpha))), -126), 126);
        const float s = ldexpf(1.f, -e);
        float ss = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lane + 32 * i > j) {
            const float y = x[i] * s;
            ss = fmaf(y, y, ss);
          }
        ss = warp_sum(ss);
        const float as = alpha * s;
        const float nrm = sqrtf(fmaf(as, as, ss)) / s;
        beta = alpha >= 0.f ? -nrm : nrm;
        tau = (beta - alpha) / beta;
        scal = 1.f / (alpha - beta);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = lane + 32 * i;
        V[j * 128 + row] = row < j ? 0.f : (row == j ? 1.f : x[i] * scal);
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
    __syncthreads();
    if (w > j) {
      const float tau = tauS[j];
      if (tau != 0.f) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dot = fmaf(V[j * 128 + lane + 32 * i], x[i], dot);
        const float f = tau * warp_sum(dot);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = fmaf(-f, V[j * 128 + lane + 32 * i], x[i]);
      }
    }
  }
  // Q's column w: H_0 ... H_w applied to e_w (H_j e_w = e_w for j > w)
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = lane + 32 * i == w ? 1.f : 0.f;
  for (int j = w; j >= 0; --j) {
    const float tau = tauS[j];
    if (tau == 0.f) continue;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dot = fmaf(V[j * 128 + lane + 32 * i], q[i], dot);
    const float f = tau * warp_sum(dot);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = fmaf(-f, V[j * 128 + lane + 32 * i], q[i]);
  }
  // qr_fixed: column w of Q and row i of R times the sign of R[i, i]
  // (1 where it is 0)
  const float sw = betaS[w] < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) Q[(lane + 32 * i) * 8 + w] = q[i] * sw;
  if (lane < BD) {
    const float si = betaS[lane] < 0.f ? -1.f : 1.f;
    Rout[lane * 8 + w] = lane <= w ? x[0] * si : 0.f;
  }
  __syncthreads();
}

// the environment update from C and A (in Q): left FL'[k, b, r] =
// sum_{m, u} C[(m, b), (r, u)] A[m, u, k] (warp b, lane (r, half of k));
// right FR'[a, l, m] = sum_{u, k} C[(a, k), (l, u)] A[m, u, k] (warp a,
// lane (l, half of m)); divided by nfactor's power of two into Eout.
// Returns the power's log2.
__device__ float env_update(float* sm, float* Eout, bool right, int t) {
  const float* C = sm + OFF_XC;
  const float* A = sm + OFF_Q;
  float* red = sm + OFF_MISC + 16;
  const int warp = t >> 5, lane = t & 31, h = lane & 15, half = lane >> 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (!right) {
    for (int m = 0; m < 8; ++m) {
      const float* cr = C + (m * 8 + warp) * CROW + h * 17;
#pragma unroll 4
      for (int u = 0; u < 16; ++u) {
        const float cv = cr[u];
        const float4 a4 =
            *reinterpret_cast<const float4*>(A + (m * 16 + u) * 8 + half * 4);
        acc[0] = fmaf(cv, a4.x, acc[0]);
        acc[1] = fmaf(cv, a4.y, acc[1]);
        acc[2] = fmaf(cv, a4.z, acc[2]);
        acc[3] = fmaf(cv, a4.w, acc[3]);
      }
    }
  } else {
    for (int k = 0; k < 8; ++k) {
      const float* cr = C + (warp * 8 + k) * CROW + h * 17;
#pragma unroll 4
      for (int u = 0; u < 16; ++u) {
        const float cv = cr[u];
        const float4 a4 =
            *reinterpret_cast<const float4*>(A + (u * 8 + k) * 8 + half * 4);
        acc[0] = fmaf(cv, a4.x, acc[0]);
        acc[1] = fmaf(cv, a4.y, acc[1]);
        acc[2] = fmaf(cv, a4.z, acc[2]);
        acc[3] = fmaf(cv, a4.w, acc[3]);
      }
    }
  }
  float mx = fmaxf(fmaxf(fabsf(acc[0]), fabsf(acc[1])),
                   fmaxf(fabsf(acc[2]), fabsf(acc[3])));
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) mx = fmaxf(mx, red[i]);
  // nfactor: the largest |entry| floored to a power of two, 1 for zero
  const int e = mx > 0.f ? ilogbf(mx) : 0;
  const float nf = ldexpf(1.f, e);
  *reinterpret_cast<float4*>(Eout + (warp * 16 + h) * 8 + half * 4) =
      make_float4(acc[0] / nf, acc[1] / nf, acc[2] / nf, acc[3] / nf);
  return static_cast<float>(e);
}

// round-robin pairs of eight columns: round r pairs column 7 with r and
// (r + k) % 7 with (r - k + 7) % 7, k = 1, 2, 3
__host__ __device__ constexpr int pair_p(int r, int k) {
  return k == 0 ? r : ((r + k) % 7 < (r - k + 7) % 7 ? (r + k) % 7
                                                     : (r - k + 7) % 7);
}
__host__ __device__ constexpr int pair_q(int r, int k) {
  return k == 0 ? 7 : ((r + k) % 7 < (r - k + 7) % 7 ? (r - k + 7) % 7
                                                     : (r + k) % 7);
}

// the singular values of the pass's n R factors: matrix g to the lanes
// 8 (g % 4) .. + 7 of warp g / 4, row i of it to lane i of the group;
// one-sided Jacobi until a sweep rotates nothing; into S[g * 8 ..], in
// descending order, divided by the largest (torch's svdvals, then
// bmps's normalisation)
__device__ void singular_values(float* sm, int n, int t) {
  const float* R = sm + OFF_R;
  float* S = sm + OFF_S;
  const int lane = t & 31, g = (t >> 5) * 4 + (lane >> 3), i = lane & 7;
  const bool live = g < n;
  float a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = live ? R[g * 64 + i * 8 + k] : 0.f;
  for (int sweep = 0; sweep < 30; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < 7; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = pair_p(r, k), q = pair_q(r, k);
        const float al = group_sum(a[p] * a[p]);
        const float be = group_sum(a[q] * a[q]);
        const float ga = group_sum(a[p] * a[q]);
        if (fabsf(ga) > FLT_EPSILON * sqrtf(al) * sqrtf(be)) {
          const float zeta = (be - al) / (2.f * ga);
          const float tn = copysignf(1.f, zeta) /
                           (fabsf(zeta) + sqrtf(fmaf(zeta, zeta, 1.f)));
          const float cs = 1.f / sqrtf(fmaf(tn, tn, 1.f));
          const float sn = cs * tn;
          const float ap = a[p], aq = a[q];
          a[p] = cs * ap - sn * aq;
          a[q] = sn * ap + cs * aq;
          rotated = true;
        }
      }
    }
    if (!__any_sync(FULL, rotated)) break;
  }
  float sig[8], mine = 0.f, top = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    sig[k] = sqrtf(group_sum(a[k] * a[k]));
    if (k == i) mine = sig[k];
    top = fmaxf(top, sig[k]);
  }
  int rank = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    rank += sig[k] > mine || (sig[k] == mine && k < i);
  if (live) S[g * 8 + rank] = mine / fmaxf(top, FLT_MIN);
}

__global__ void __launch_bounds__(NT, 1) polish_kernel(const Args g) {
  extern __shared__ float4 polish_smem[];
  float* sm = reinterpret_cast<float*>(polish_smem);
  const int t = threadIdx.x, z = blockIdx.x, L = g.L;
  float* E = sm + OFF_E;
  float* R = sm + OFF_R;
  float* S = sm + OFF_S;
  float* SL = sm + OFF_MISC + 24;
  float* dsh = sm + OFF_MISC + 32;
  float* Aout = g.A_out + static_cast<long long>(z) * L * ENV;

  // slot 0: the trivial left environment; the Schmidt values at the last
  // bond start as (1, 0, ..., 0)
  for (int i = t; i < ENV; i += NT) E[i] = i == 0 ? 1.f : 0.f;
  if (t < BD) SL[t] = t == 0 ? 1.f : 0.f;

  // the left environments of the zip-up output A0 (slots 1 .. L)
  float ln = 0.f;
  for (int n = 0; n < L; ++n) {
    begin_step(sm, g, z, n, false, true, t);
    x_left(sm, E + n * ENV, t);
    __syncthreads();
    gemm(sm, g.W + z * g.w_b + n * g.w_n, false, t);
    ln += env_update(sm, E + (n + 1) * ENV, false, t);
  }
  __syncthreads();
  float overlap = E[L * ENV] * exp2f(ln);
  __syncthreads();  // read by all before the right sweep resets slot L
  float diff = 1.f, prev = INFINITY, ln_state = 0.f;
  int sweeps = 0;
  while (going(diff, prev, sweeps, g.tol, g.max_sweeps)) {
    // right sweep, sites L - 1 .. 1: FR of site n in slot n + 1, the new
    // one replaces FL in slot n
    for (int i = t; i < ENV; i += NT) E[L * ENV + i] = i == 0 ? 1.f : 0.f;
    for (int n = L - 1; n >= 1; --n) {
      begin_step(sm, g, z, n, true, false, t);
      x_right(sm, E + (n + 1) * ENV, t);
      __syncthreads();
      gemm(sm, g.W + z * g.w_b + n * g.w_n, true, t);
      proj_right(sm, E + n * ENV, t);
      __syncthreads();
      qr(sm, R + (L - 1 - n) * 64, t);
      env_update(sm, E + n * ENV, true, t);
    }
    // left sweep, sites 0 .. L - 1: FL of site n in slot n, the new one
    // replaces FR in slot n + 1
    ln = 0.f;
    float ln1 = 0.f;
    for (int n = 0; n < L; ++n) {
      begin_step(sm, g, z, n, false, false, t);
      x_left(sm, E + n * ENV, t);
      __syncthreads();
      gemm(sm, g.W + z * g.w_b + n * g.w_n, false, t);
      proj_left(sm, E + (n + 1) * ENV, t);
      __syncthreads();
      qr(sm, R + (L - 1 + n) * 64, t);
      // at the last site the right environment is trivial, so
      // |R[0, 0]| 2^ln is the norm of the projected state
      ln1 = ln + log2f(fmaxf(fabsf(sm[OFF_MISC + 8]), FLT_MIN));
      reinterpret_cast<float4*>(Aout + n * ENV)[t] =
          reinterpret_cast<const float4*>(sm + OFF_Q)[t];
      ln += env_update(sm, E + (n + 1) * ENV, false, t);
    }
    __syncthreads();
    const float ov1 = E[L * ENV] * exp2f(ln);
    singular_values(sm, 2 * L - 1, t);
    __syncthreads();
    if (t < 32) {
      // the Schmidt-vector change: left step n against right step n + 1
      // (the last bond against the previous pass's)
      float dn = 0.f;
      if (t < L) {
        const float* snew = S + (L - 1 + t) * 8;
        const float* sold = t + 1 <= L - 1 ? S + (L - 2 - t) * 8 : SL;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < BD; ++j) {
          const float d = sold[j] - snew[j];
          s = fmaf(d, d, s);
        }
        dn = sqrtf(s);
      }
      dn = warp_max(dn);
      __syncwarp();
      if (t < BD) SL[t] = S[(2 * L - 2) * 8 + t];
      if (t == 0) *dsh = dn;
    }
    __syncthreads();
    prev = diff;
    diff = *dsh;
    overlap = ov1;
    ln_state = ln1;
    ++sweeps;
  }
  if (sweeps == 0) {
    // no pass: the zip-up output stands
    for (int i = t; i < L * ENV; i += NT) {
      const int n = i >> 10, a = (i >> 7) & 7, d = (i >> 3) & 15, b = i & 7;
      Aout[i] = g.A0[z * g.a_b + n * g.a_n + a * g.a_0 + d * g.a_1 +
                     b * g.a_2];
    }
  }
  if (t == 0) {
    g.overlap[z] = overlap;
    g.ln_state[z] = ln_state;
    g.sweeps[z] = sweeps;
  }
}

// ---- host side: the launch

}  // namespace

extern "C" {

int tnax_polish_f32(const void* A0, long long a_b, long long a_n,
                    long long a_0, long long a_1, long long a_2,
                    const void* phi, long long p_b, long long p_n,
                    long long p_0, long long p_1, long long p_2,
                    const void* W, long long w_b, long long w_n, int B, int L,
                    double tol, int max_sweeps, void* A_out, void* overlap,
                    void* ln_state, void* sweeps, void* stream) {
  if (B < 0 || L < 1 || L > LMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        polish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const Args g{static_cast<const float*>(A0),
               a_b, a_n, a_0, a_1, a_2,
               static_cast<const float*>(phi),
               p_b, p_n, p_0, p_1, p_2,
               static_cast<const float*>(W), w_b, w_n,
               static_cast<float*>(A_out), static_cast<float*>(overlap),
               static_cast<float*>(ln_state),
               static_cast<long long*>(sweeps), L, max_sweeps,
               static_cast<float>(tol)};
  polish_kernel<<<B, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
