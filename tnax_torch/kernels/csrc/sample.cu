// K4: the Gibbs sampler's per-site draw, one thread block per walker row
// (b, m) of a fleet (grid of B * M blocks, one launch per site).
//
// Replaces tnax/engine.py `marginal_step`'s elementwise tail (after its
// two GEMMs) and the inverse-CDF draw of tnax/parallel.py `sample_rows`
// (cums = cumsum(Pn); indc = clip(sum(cums < u), 0, nvalid - 1)), vmapped
// over the fleet's instances. Block (b, m)
//   1. gathers g[s] = T2[b, m, drindex[b, s]] and the Boltzmann column
//      lB[b, s, lidx[b, m], uidx[b, m]] of its Np states (threads loop
//      over the states when Np exceeds the block);
//   2. subtracts the column's maximum (0 when it is not finite),
//      exponentiates and masks the states s >= nvalid[b];
//   3. takes the minimum mPn over the valid states; when it is negative,
//      clamps the valid states below |mPn| to |mPn| and scales mPn by
//      their count;
//   4. normalizes by the sum, or takes the uniform row over the valid
//      states when the sum is not positive (mPn = -1 then);
//   5. runs an inclusive block scan of the normalized row (warp shuffles,
//      then one shared word per warp) and counts the cumulative sums
//      below the walker's uniform u[b, m]; the count, clipped to
//      [0, nvalid - 1], is the drawn state.
// It writes indc[b, m] and mPn[b, m] and nothing else: the row lives in
// dynamic shared memory (Np words), no atomics, no allocation.
//
// What bounds it on the card: bytes and launches, not arithmetic. A
// launch reads B * M * (2 * Np) gathered words and writes 2 * B * M
// values; eager PyTorch runs the same tail as some thirty launches over
// (B, M, Np) temporaries plus a cumsum and a comparison. Here it is one
// launch per site for the whole fleet, and the row never leaves the SM.
// The scan adds in another order than torch.cumsum, so a draw can differ
// from the plain version's only where u lies within rounding of a
// cumulative boundary.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float ninf() {
    return __int_as_float(static_cast<int>(0xff800000u));
  }
  __device__ static float big() { return FLT_MAX; }
  __device__ static float ex(float x) { return expf(x); }
};

template <>
struct Num<double> {
  __device__ static double ninf() {
    return __longlong_as_double(0xfff0000000000000ULL);
  }
  __device__ static double big() { return DBL_MAX; }
  __device__ static double ex(double x) { return exp(x); }
};

struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return b > a ? b : a; }
};
struct Min {
  template <typename T>
  __device__ T operator()(T a, T b) const { return b < a ? b : a; }
};
struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};

// Reduce v over the block; every thread returns the same bits (the warp
// partials are folded in one fixed order). `red` holds kWarps words.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_xor_sync(FULL, v, off));
  __syncthreads();  // an earlier call may still read red
  if (lane == 0) red[w] = v;
  __syncthreads();
  T r = red[0];
  for (int i = 1; i < kWarps; ++i) r = op(r, red[i]);
  return r;
}

// Inclusive scan of v over the block in thread order; `total` receives
// the block's sum. `red` holds kWarps words.
template <typename T>
__device__ T block_scan(T v, T* red, T& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const T n = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += n;
  }
  __syncthreads();
  if (lane == 31) red[w] = v;
  __syncthreads();
  T pre = T(0);
  total = T(0);
  for (int i = 0; i < kWarps; ++i) {
    if (i < w) pre += red[i];
    total += red[i];
  }
  return pre + v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sample_draw_kernel(const T* __restrict__ T2, const T* __restrict__ lB,
                   const int32_t* __restrict__ drindex,
                   const int32_t* __restrict__ lidx,
                   const int32_t* __restrict__ uidx,
                   const int32_t* __restrict__ nvalid,
                   const T* __restrict__ u, int M, int Np, int lhlv, int lv,
                   int32_t* __restrict__ indc, T* __restrict__ mPn_out) {
  extern __shared__ unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);  // the row, Np words
  __shared__ T red[kWarps];
  __shared__ int redi[kWarps];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;  // b * M + m
  const int b = row / M;
  const int nv = nvalid[b];
  const T* t2 = T2 + static_cast<size_t>(row) * lhlv;
  const T* lb = lB + static_cast<size_t>(b) * Np * lhlv + lidx[row] * lv
                + uidx[row];
  const int32_t* dr = drindex + static_cast<size_t>(b) * Np;

  // 1-2. the Boltzmann column and its maximum over all Np states
  T lmax = Num<T>::ninf();
  for (int s = tid; s < Np; s += kThreads) {
    const T x = lb[static_cast<size_t>(s) * lhlv];
    P[s] = x;
    lmax = Max()(lmax, x);
  }
  T shift = block_reduce(lmax, Max(), red);
  if (!(shift >= -Num<T>::big() && shift <= Num<T>::big()))
    shift = T(0);  // not finite

  // 3. the masked marginals and their minimum over the valid states
  T lmin = Num<T>::big();
  for (int s = tid; s < Np; s += kThreads) {
    const T p = s < nv ? t2[dr[s]] * Num<T>::ex(P[s] - shift) : T(0);
    P[s] = p;
    if (s < nv) lmin = Min()(lmin, p);
  }
  T mPn = block_reduce(lmin, Min(), red);
  const bool neg = mPn < T(0);
  const T amin = neg ? -mPn : mPn;
  int lclip = 0;
  T lsum = T(0);
  for (int s = tid; s < Np; s += kThreads) {
    T p = P[s];
    if (neg && s < nv && p < amin) {
      p = amin;
      P[s] = p;
      ++lclip;
    }
    lsum += p;
  }
  const int nclip = block_reduce(lclip, Sum(), redi);
  const T no = block_reduce(lsum, Sum(), red);
  if (neg) mPn *= static_cast<T>(nclip);

  // 4. normalization, or the uniform row
  const bool good = no > T(0);
  mPn = good ? mPn / no : T(-1);
  const T unif = T(1) / static_cast<T>(nv);
  for (int s = tid; s < Np; s += kThreads)
    P[s] = good ? P[s] / no : (s < nv ? unif : T(0));
  __syncthreads();  // the scan reads the row in tiles of kThreads

  // 5. inclusive scan in state order, and the count of sums below u
  const T uu = u[row];
  T carry = T(0);
  int lcnt = 0;
  for (int base = 0; base < Np; base += kThreads) {
    const int s = base + tid;
    T total;
    const T c = carry + block_scan(s < Np ? P[s] : T(0), red, total);
    if (s < Np && c < uu) ++lcnt;
    carry += total;
  }
  const int cnt = block_reduce(lcnt, Sum(), redi);
  if (tid == 0) {
    indc[row] = cnt < 0 ? 0 : (cnt > nv - 1 ? nv - 1 : cnt);
    mPn_out[row] = mPn;
  }
}

template <typename T>
int launch(const void* T2, const void* lB, const void* drindex,
           const void* lidx, const void* uidx, const void* nvalid,
           const void* u, int B, int M, int Np, int lhlv, int lv, void* indc,
           void* mPn, void* stream) {
  if (B * M == 0) return 0;
  sample_draw_kernel<T><<<B * M, kThreads, sizeof(T) * Np,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(T2), static_cast<const T*>(lB),
      static_cast<const int32_t*>(drindex), static_cast<const int32_t*>(lidx),
      static_cast<const int32_t*>(uidx), static_cast<const int32_t*>(nvalid),
      static_cast<const T*>(u), M, Np, lhlv, lv, static_cast<int32_t*>(indc),
      static_cast<T*>(mPn));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tnax_sample_draw_f32(const void* T2, const void* lB, const void* drindex,
                         const void* lidx, const void* uidx,
                         const void* nvalid, const void* u, int B, int M,
                         int Np, int lhlv, int lv, void* indc, void* mPn,
                         void* stream) {
  return launch<float>(T2, lB, drindex, lidx, uidx, nvalid, u, B, M, Np,
                       lhlv, lv, indc, mPn, stream);
}

int tnax_sample_draw_f64(const void* T2, const void* lB, const void* drindex,
                         const void* lidx, const void* uidx,
                         const void* nvalid, const void* u, int B, int M,
                         int Np, int lhlv, int lv, void* indc, void* mPn,
                         void* stream) {
  return launch<double>(T2, lB, drindex, lidx, uidx, nvalid, u, B, M, Np,
                        lhlv, lv, indc, mPn, stream);
}

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
