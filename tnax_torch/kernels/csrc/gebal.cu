// K1: LAPACK dgebal-style balancing scales, one warp per matrix.
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
// decisions. In eager PyTorch every loop test is a host sync, thousands
// per call. Here the whole nest runs inside one warp: the matrix sits in
// shared memory, lane j holds row j of column i and column j of row i,
// the two norms are butterfly sums (every lane ends with the same bits,
// so the while loops are warp-uniform), and the only host interaction is
// the launch. Powers of two make the scaling exact, so the scales equal
// the plain version's bit for bit whenever the norms round alike.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void gebal_kernel(const T* __restrict__ A,
                             const int* __restrict__ nd, T max_scale, int n,
                             int batch, T* __restrict__ scale_out) {
  extern __shared__ unsigned char smem_raw[];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarpsPerBlock + w;
  if (b >= batch) return;  // whole warp leaves together
  T* a = reinterpret_cast<T*>(smem_raw) + w * n * n;
  const int ndb = nd[b];
  for (int idx = lane; idx < n * n; idx += 32) {
    const int r = idx / n, c = idx % n;
    a[idx] = (r < ndb && c < ndb) ? A[(size_t)b * n * n + idx] : T(0);
  }
  __syncwarp();

  T scale = T(1);
  bool noconv = true;
  for (int it = 0; it < 64 && noconv; ++it) {
    noconv = false;
    for (int i = 0; i < n; ++i) {
      const T cv = lane < n ? a[lane * n + i] : T(0);  // column i
      const T rv = lane < n ? a[i * n + lane] : T(0);  // row i
      T c2 = cv * cv, r2 = rv * rv;
      for (int off = 16; off > 0; off >>= 1) {
        c2 += __shfl_xor_sync(FULL, c2, off);
        r2 += __shfl_xor_sync(FULL, r2, off);
      }
      const T c = sqrt(c2), r = sqrt(r2);
      const bool ok = c > T(0) && r > T(0) && i < ndb;
      const T s = c + r;
      T cc = ok ? c : T(1), rr = ok ? r : T(1), f = T(1);
      while (cc < rr * T(0.5)) {  // LAPACK's first scaling loop
        cc *= T(2); rr *= T(0.5); f *= T(2);
      }
      while (cc * T(0.5) >= rr) {  // LAPACK's second scaling loop
        cc *= T(0.5); rr *= T(2); f *= T(0.5);
      }
      if (ok && (cc + rr) < T(0.95) * s && f != T(1)) {
        if (lane < n) a[lane * n + i] *= f;
        __syncwarp();
        if (lane < n) a[i * n + lane] /= f;
        __syncwarp();
        if (lane == i) scale *= f;
        noconv = true;
      }
    }
  }
  if (lane < n) {
    const T lo = T(1) / max_scale;
    scale_out[(size_t)b * n + lane] = scale < lo ? lo
                                    : (scale > max_scale ? max_scale : scale);
  }
}

template <typename T>
int launch(const void* A, const void* nd, double max_scale, int n, int batch,
           void* out, void* stream) {
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = sizeof(T) * n * n * kWarpsPerBlock;
  gebal_kernel<T><<<blocks, 32 * kWarpsPerBlock, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const int*>(nd), T(max_scale), n,
      batch, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tnax_gebal_f32(const void* A, const void* nd, double max_scale, int n,
                   int batch, void* out, void* stream) {
  return launch<float>(A, nd, max_scale, n, batch, out, stream);
}

int tnax_gebal_f64(const void* A, const void* nd, double max_scale, int n,
                   int batch, void* out, void* stream) {
  return launch<double>(A, nd, max_scale, n, batch, out, stream);
}

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
