// K3: the beam search's marginal epilogue, one warp per branch row (b, m)
// of a fleet and up to kMaxWarps rows per block (one launch per site).
//
// Replaces tnax/engine.py `marginal_step`'s elementwise tail (after its two
// GEMMs) and the search's log2-probabilities and row reductions of
// tnax/parallel.py `row_step` (logP, probf, pmax, and the negativeness
// flags mq and mqc), vmapped over the fleet's instances. Steps 1-4 are
// epilogue.cuh's, which K4 (sample.cu) shares. Warp (b, m)
//   1. reads the Boltzmann column lBT[b, lidx, uidx, :] of its Np states
//      (contiguous: the table is transposed once per search) into its
//      share of shared memory, and takes the column's maximum (0 when it
//      is not finite);
//   2. forms Pn[s] = T2[b, m, drindex[b, s]] * exp(col[s] - max) for the
//      valid states s < nvalid[b], 0 beyond;
//   3. takes the minimum mPn over the valid states; when it is negative,
//      clamps the valid states below |mPn| to |mPn| and scales mPn by
//      their count;
//   4. normalizes by the sum, or takes the uniform row over the valid
//      states when the sum is not positive (mPn = -1 then);
//   5. writes probf[b, m, s] = prob[b, m] + log2(Pn[s]) (NEG where
//      Pn[s] <= 0 or the branch is invalid) and mPn[b, m];
//   6. folds its row into the instance's reductions: pmax, the maximum of
//      probf; mq, the minimum of mPn over valid branches (0 for the
//      others); mqc, the same over the core branches, valid and with
//      prob > bmax + log2_cutoff, bmax the instance's best valid prob
//      (each warp takes it over the instance's M branches).
// The reductions are min and max, so they are exact in any order: each
// block folds its rows per instance and meets the other blocks through
// 64-bit atomicMax on order-preserving integer images (a minimum as the
// maximum of the complement). The images start at 0 (a memset before the
// launch), and the last block to finish decodes them into pmax, mq, mqc.
//
// What bounds it on the card: bytes and launches, not arithmetic. Each
// launch reads the instance's distinct Boltzmann columns and T2's valid
// entries and writes B * M * Np values of probf; the column reads are
// coalesced (a warp reads 32 consecutive states), where the Triton kernel
// it replaces read one 32-byte sector per state. The indices are read as
// the caller holds them (int64, and valid as bytes), so no cast kernels
// run before it, and the ten reduction launches that followed it in
// row_step are gone. Exponentials and logarithms are CUDA's exp/expf and
// log2/log2f.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

#include "epilogue.cuh"

namespace {

using tnax::Max;
using tnax::Min;
using tnax::Num;

constexpr int kMaxWarps = 8;
constexpr int kRowBytes = 48 * 1024;   // static limit of a block's rows

// An unsigned image of x that orders as x does.
__device__ unsigned long long ordered(double x) {
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(x));
  return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
}

__device__ double unordered(unsigned long long u) {
  return __longlong_as_double(static_cast<long long>(
      (u >> 63) ? (u & 0x7fffffffffffffffull) : ~u));
}

template <typename T>
struct Args {
  const T* T2;             // (B, M, lhlv), rows contiguous
  long long t2_b;          // batch stride
  const T* lBT;            // (B, lh, lv, Np), one instance contiguous
  long long lbt_b;
  const int64_t* dr;       // (B, Np)
  long long dr_b;
  const int64_t* lidx;     // (B, M) contiguous
  const int64_t* uidx;
  const int64_t* nvalid;   // (B,)
  long long nv_b;
  const T* prob;           // (B, M) contiguous
  const uint8_t* valid;
  int B, M, Np, lv, lhlv;
  T log2_cutoff, neg;
  T* probf;                // (B, M, Np)
  T* mPn;                  // (B, M)
  T* pmax;                 // (B,) each
  T* mq;
  T* mqc;
  unsigned long long* red; // 3 B images, then the count of finished blocks
};

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
marginal_kernel(Args<T> a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int rb[kMaxWarps];          // instance of each warp's row
  __shared__ double rv[kMaxWarps][3];    // its pmax, mq and mqc terms
  __shared__ bool last;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T* P = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(w) * a.Np;
  const long long r = static_cast<long long>(blockIdx.x) * nw + w;
  if (lane == 0) rb[w] = -1;
  if (r < static_cast<long long>(a.B) * a.M) {
    const int b = static_cast<int>(r / a.M);
    const int m = static_cast<int>(r - static_cast<long long>(b) * a.M);
    const T* pb = a.prob + static_cast<size_t>(b) * a.M;
    const uint8_t* vb = a.valid + static_cast<size_t>(b) * a.M;
    T bmax = Num<T>::ninf();
    for (int j = lane; j < a.M; j += 32)
      bmax = Max()(bmax, vb[j] ? pb[j] : a.neg);
    bmax = tnax::warp_all(bmax, Max());

    // 1-4. the marginals (epilogue.cuh), the row in shared memory with
    // the states lane, lane + 32, ...
    const int Np = a.Np;
    const int nv = static_cast<int>(a.nvalid[b * a.nv_b]);
    const T* col = a.lBT + b * a.lbt_b + (a.lidx[r] * a.lv + a.uidx[r]) * Np;
    const T* t2 = a.T2 + b * a.t2_b + static_cast<long long>(m) * a.lhlv;
    tnax::SmemRow<T, false> row(P, lane, (Np + 31) / 32);
    const tnax::Epilogue<T> e =
        tnax::marginal_row<T>(row, col, t2, a.dr + b * a.dr_b, Np, nv);
    const T mPn = e.mPn;

    // 5. log2 of the normalized marginals, the branch's prob
    const bool vr = a.valid[r] != 0;
    const T pr = a.prob[r];
    T* out = a.probf + r * Np;
    T lp = Num<T>::ninf();
    for (int s = lane; s < Np; s += 32) {
      const T q = e.pn(P[s], s, nv);
      const T lg = q > T(0) ? Num<T>::lg2(q) : a.neg;
      const T o = vr ? pr + lg : a.neg;
      out[s] = o;
      lp = Max()(lp, o);
    }
    lp = tnax::warp_all(lp, Max());

    // 6. this row's terms of the instance's reductions
    if (lane == 0) {
      a.mPn[r] = mPn;
      const bool core = vr && pr > bmax + a.log2_cutoff;
      rb[w] = b;
      rv[w][0] = static_cast<double>(lp);
      rv[w][1] = vr ? static_cast<double>(mPn) : 0.0;
      rv[w][2] = core ? static_cast<double>(mPn) : 0.0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // fold the block's rows instance by instance (rows are in instance
    // order), one set of atomics per instance
    int cur = -1;
    double v0 = 0.0, v1 = 0.0, v2 = 0.0;
    for (int k = 0; k <= nw; ++k) {
      const int bk = k < nw ? rb[k] : -1;
      if (bk != cur) {
        if (cur >= 0) {
          atomicMax(&a.red[3 * cur], ordered(v0));
          atomicMax(&a.red[3 * cur + 1], ~ordered(v1));
          atomicMax(&a.red[3 * cur + 2], ~ordered(v2));
        }
        cur = bk;
        if (bk >= 0) {
          v0 = rv[k][0];
          v1 = rv[k][1];
          v2 = rv[k][2];
        }
      } else if (bk >= 0) {
        v0 = Max()(v0, rv[k][0]);
        v1 = Min()(v1, rv[k][1]);
        v2 = Min()(v2, rv[k][2]);
      }
    }
    __threadfence();
    const unsigned long long done = atomicAdd(&a.red[3 * a.B], 1ull);
    last = done == gridDim.x - 1ull;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    const volatile unsigned long long* red = a.red;
    for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
      a.pmax[b] = static_cast<T>(unordered(red[3 * b]));
      a.mq[b] = static_cast<T>(unordered(~red[3 * b + 1]));
      a.mqc[b] = static_cast<T>(unordered(~red[3 * b + 2]));
    }
  }
}

template <typename T>
int launch(const void* T2, long long t2_b, const void* lBT, long long lbt_b,
           const void* drindex, long long dr_b, const void* lidx,
           const void* uidx, const void* nvalid, long long nv_b,
           const void* prob, const void* valid, int B, int M, int Np, int lv,
           int lhlv, double log2_cutoff, double neg, void* probf, void* mPn,
           void* pmax, void* mq, void* mqc, void* red, void* stream) {
  if (B < 1 || M < 1 || Np < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = std::max(
      1, std::min(kMaxWarps, kRowBytes / static_cast<int>(sizeof(T) * Np)));
  if (static_cast<size_t>(nw) * Np * sizeof(T) > kRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      red, 0, sizeof(unsigned long long) * (3 * static_cast<size_t>(B) + 1),
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args<T> a{static_cast<const T*>(T2), t2_b, static_cast<const T*>(lBT),
            lbt_b, static_cast<const int64_t*>(drindex), dr_b,
            static_cast<const int64_t*>(lidx),
            static_cast<const int64_t*>(uidx),
            static_cast<const int64_t*>(nvalid), nv_b,
            static_cast<const T*>(prob), static_cast<const uint8_t*>(valid),
            B, M, Np, lv, lhlv, static_cast<T>(log2_cutoff),
            static_cast<T>(neg), static_cast<T*>(probf),
            static_cast<T*>(mPn), static_cast<T*>(pmax), static_cast<T*>(mq),
            static_cast<T*>(mqc), static_cast<unsigned long long*>(red)};
  const long long rows = static_cast<long long>(B) * M;
  const long long blocks = (rows + nw - 1) / nw;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  marginal_kernel<T><<<static_cast<unsigned>(blocks), nw * 32,
                       sizeof(T) * nw * Np, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define TNAX_MARGINAL_ENTRY(name, T)                                         \
  int name(const void* T2, long long t2_b, const void* lBT, long long lbt_b, \
           const void* drindex, long long dr_b, const void* lidx,            \
           const void* uidx, const void* nvalid, long long nv_b,             \
           const void* prob, const void* valid, int B, int M, int Np,        \
           int lv, int lhlv, double log2_cutoff, double neg, void* probf,    \
           void* mPn, void* pmax, void* mq, void* mqc, void* red,            \
           void* stream) {                                                   \
    return launch<T>(T2, t2_b, lBT, lbt_b, drindex, dr_b, lidx, uidx,        \
                     nvalid, nv_b, prob, valid, B, M, Np, lv, lhlv,          \
                     log2_cutoff, neg, probf, mPn, pmax, mq, mqc, red,       \
                     stream);                                                \
  }

TNAX_MARGINAL_ENTRY(tnax_marginal_f32, float)
TNAX_MARGINAL_ENTRY(tnax_marginal_f64, double)

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
