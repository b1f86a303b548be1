// K1: LAPACK dgebal-style balancing scales, the matrix in registers: one
// matrix per half-warp for n <= 16, one per warp for 17 <= n <= 32.
//
// Replaces tnax/precondition.py `gebal_scale` (a jitted lax.while_loop /
// fori_loop nest in JAX). For each n x n matrix (n <= 32) of a batch it
// runs the no-permutation scaling pass of LAPACK gebal on the leading
// nd x nd block: up to 64 passes over the columns; for column i the
// column and row 2-norms c and r decide a power-of-two factor f through
// two data-dependent while loops, and the column is multiplied by f, the
// row divided by it, when that shrinks c + r below 0.95 of its old value.
// Scales are clipped to [1/max_scale, max_scale].
//
// What bounds it on the card: nothing of bandwidth or arithmetic (a
// 16 x 16 matrix is 2 KB in f64); it is a chain of dependent scalar
// decisions, up to 64 passes of n column steps, each exposed in full with
// one warp on an SM. The design shortens each step:
//   - lane j of a group of N lanes (N = 16 or 32) holds column j and row j
//     of the matrix in registers (a copy of each entry in two lanes, kept
//     bit-equal: both take the same multiply and divide); the column loop
//     is unrolled, so entry i of a lane's column or row is a fixed
//     register. Each lane keeps the norms of its column and row, fixed-
//     order sums, and recomputes them only after a step that scaled (most
//     steps scale nothing, and an unchanged matrix gives the same bits);
//     step i broadcasts lane i's two norms by two shuffles: no butterfly,
//     no shared memory, no barrier;
//   - LAPACK's two loops run as written: two comparisons when neither
//     runs, the common case;
//   - f = 2^k, so the step that scales divides once, for 1 / f, and
//     multiplies by it wherever that is exact;
//   - two matrices share a warp at n <= 16 (no idle half), and the passes
//     run until both have converged: a matrix whose pass changed nothing
//     sees the same matrix again and changes nothing, so its scales are
//     those of a run alone.
// The scales equal the plain version's bit for bit whenever the norms
// round alike.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Scaled {
  T c, r, f;
};

// LAPACK's two scaling loops on (c, r):
//   (1) while c < r/2: c *= 2, r /= 2, f *= 2;
//   (2) while c/2 >= r: c /= 2, r *= 2, f /= 2.
// After a step of (1), c < 2 r, so (2) runs only when (1) did not. Returns
// c, r as the loops leave them and f.
template <typename T>
__device__ __forceinline__ Scaled<T> loops(T c, T r) {
  T f = T(1);
  while (c < r * T(0.5)) {
    c *= T(2); r *= T(0.5); f *= T(2);
  }
  while (c * T(0.5) >= r) {
    c *= T(0.5); r *= T(2); f *= T(0.5);
  }
  return {c, r, f};
}

// the squared 2-norm of a lane's N registers, in a fixed order
template <typename T, int N>
__device__ T norm2(const T (&v)[N]) {
  T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < N; ++k) s[k & 3] += v[k] * v[k];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// N lanes per matrix (16: two matrices per warp; 32: one)
template <typename T, int N>
__global__ void __launch_bounds__(64)
gebal_kernel(const T* __restrict__ A, long long sb, long long si,
             long long sj, const void* __restrict__ nd, long long nd_b,
             int nd64, T max_scale, int n, int batch, T* __restrict__ out) {
  constexpr int G = 32 / N;
  const int lane = threadIdx.x & 31;
  const int j = lane % N;  // this lane's column and row
  const long long w0 = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                        + (threadIdx.x >> 5)) * G;
  if (w0 >= batch) return;  // the whole warp leaves together
  const long long b = w0 + lane / N;
  const bool live = b < batch;  // a dead group holds zeros: never scales
  int ndb = 0;
  if (live)
    ndb = nd64 ? static_cast<int>(static_cast<const long long*>(nd)[b * nd_b])
               : static_cast<const int*>(nd)[b * nd_b];
  const int nn = ndb < n ? ndb : n;
  T col[N], row[N];  // col[k] = A[k, j], row[k] = A[j, k]
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool in = k < nn && j < nn;
    col[k] = in ? A[b * sb + k * si + j * sj] : T(0);
    row[k] = in ? A[b * sb + j * si + k * sj] : T(0);
  }

  T scale = T(1), cn = T(0), rn = T(0);  // cn, rn: this lane's norms
  bool noconv = true, stale = true;
  for (int it = 0; it < 64 && noconv; ++it) {
    bool changed = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (stale) {
        cn = sqrt(norm2(col));
        rn = sqrt(norm2(row));
        stale = false;
      }
      // lane i's column and row are column i and row i
      const T c = __shfl_sync(FULL, cn, i, N);
      const T r = __shfl_sync(FULL, rn, i, N);
      const bool ok = c > T(0) && r > T(0) && i < ndb;
      const T s = c + r;
      const Scaled<T> q = loops(ok ? c : T(1), ok ? r : T(1));
      if (ok && (q.c + q.r) < T(0.95) * s && q.f != T(1)) {
        // f = 2^k, so x / f is x * (1 / f) bit for bit when 1 / f is
        // exact, which rf * f == 1 tells: one division, not N + 1
        const T f = q.f, rf = T(1) / f;
        const bool exact = rf * f == T(1);
        // column i times f, then row i over f, as LAPACK orders them
        row[i] *= f;
        if (j == i) {
#pragma unroll
          for (int k = 0; k < N; ++k) col[k] *= f;
          if (exact) {
#pragma unroll
            for (int k = 0; k < N; ++k) row[k] *= rf;
          } else {
#pragma unroll
            for (int k = 0; k < N; ++k) row[k] /= f;
          }
          scale *= f;
        }
        if (exact)
          col[i] *= rf;
        else
          col[i] /= f;
        changed = stale = true;
      }
    }
    noconv = __any_sync(FULL, changed);
  }
  if (live && j < n) {
    const T lo = T(1) / max_scale;
    out[b * n + j] = scale < lo ? lo : (scale > max_scale ? max_scale : scale);
  }
}

template <typename T>
int launch(const void* A, long long sb, long long si, long long sj,
           const void* nd, long long nd_b, int nd64, double max_scale, int n,
           int batch, void* out, void* stream) {
  if (n < 1 || n > 32 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int G = n <= 16 ? 2 : 1;
  const long long warps = (batch + G - 1) / G;
  // one warp per block, so that few matrices spread over as many SMs;
  // two once the card's 132 SMs hold two blocks each
  const int wpb = warps > 264 ? 2 : 1;
  const long long blocks = (warps + wpb - 1) / wpb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 2)
    gebal_kernel<T, 16><<<static_cast<unsigned>(blocks), 32 * wpb, 0, st>>>(
        static_cast<const T*>(A), sb, si, sj, nd, nd_b, nd64, T(max_scale), n,
        batch, static_cast<T*>(out));
  else
    gebal_kernel<T, 32><<<static_cast<unsigned>(blocks), 32 * wpb, 0, st>>>(
        static_cast<const T*>(A), sb, si, sj, nd, nd_b, nd64, T(max_scale), n,
        batch, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tnax_gebal_f32(const void* A, long long sb, long long si, long long sj,
                   const void* nd, long long nd_b, int nd64, double max_scale,
                   int n, int batch, void* out, void* stream) {
  return launch<float>(A, sb, si, sj, nd, nd_b, nd64, max_scale, n, batch,
                       out, stream);
}

int tnax_gebal_f64(const void* A, long long sb, long long si, long long sj,
                   const void* nd, long long nd_b, int nd64, double max_scale,
                   int n, int batch, void* out, void* stream) {
  return launch<double>(A, sb, si, sj, nd, nd_b, nd64, max_scale, n, batch,
                        out, stream);
}

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
