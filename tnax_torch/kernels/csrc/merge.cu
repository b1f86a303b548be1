// K2: beam-merge grouping and segment statistics, one thread block.
//
// Replaces the key1 path of tnax/parallel.py `merge_candidates` (a
// stable jnp.argsort of C int32 keys, a cumsum of key changes, and five
// jax.ops segment reductions). For C <= 8192 candidates it
//   1. sorts (key, index) pairs: the key's sign bit is flipped and the
//      candidate index packed below it, so one ascending sort of unique
//      64-bit words is the stable sort of the signed keys;
//   2. numbers the runs of equal keys (segment ids, a block-wide scan);
//   3. walks each segment in sorted order: the minimum energy over valid
//      members, the first sorted position holding it, the members within
//      min_dEng of it, their mean log2-probability and the int64 sum of
//      their degeneracies.
// Outputs are indexed like the plain version's: perm and seg by sorted
// position, the statistics by segment id; ids with no valid member hold
// Emin = max, first_min = C, gprob = NEG, deg = 0. Energies are float64
// in both instantiations; T is the probability type.
//
// What bounds it on the card: latency, not bandwidth (8192 candidates
// are ~150 KB of input). In eager PyTorch the same work is a sort plus a
// dozen small launches each site. Here it is one launch: the bitonic sort
// runs on 64 KB of dynamic shared memory (91 compare-exchange stages of
// 1024 threads), the scan and the segment walk stay in the block, and a
// segment's sums are taken in sorted order, the order the CPU reference
// adds them in.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxC = 8192;

__device__ __forceinline__ uint32_t hi(uint64_t v) {
  return static_cast<uint32_t>(v >> 32);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const int32_t* __restrict__ key1,
             const double* __restrict__ Eng,
             const T* __restrict__ prob, const uint8_t* __restrict__ valid,
             const int64_t* __restrict__ deg, double min_dEng, T neg, int C,
             int N, int64_t* __restrict__ perm, int64_t* __restrict__ seg,
             double* __restrict__ Emin, int64_t* __restrict__ first_min,
             T* __restrict__ gprob, int64_t* __restrict__ deg_seg) {
  extern __shared__ uint64_t s[];  // N sort words
  __shared__ int cnt[kThreads];
  const int tid = threadIdx.x;

  for (int i = tid; i < N; i += kThreads) {
    if (i < C) {
      const uint32_t k = static_cast<uint32_t>(key1[i]) ^ 0x80000000u;
      s[i] = (static_cast<uint64_t>(k) << 32) | static_cast<uint32_t>(i);
    } else {
      s[i] = ~0ull;
    }
  }
  for (int j = tid; j < C; j += kThreads) {
    Emin[j] = DBL_MAX;
    first_min[j] = C;
    gprob[j] = neg;
    deg_seg[j] = 0;
  }
  __syncthreads();

  // 1. bitonic sort, ascending
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < N; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = s[i], b = s[ixj];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // 2. segment ids: each thread counts the key changes in its chunk,
  //    a Hillis-Steele scan gives the chunk offsets
  const int per = (C + kThreads - 1) / kThreads;
  const int lo = tid * per;
  const int hi_ = min(lo + per, C);
  int local = 0;
  for (int i = max(lo, 1); i < hi_; ++i) local += hi(s[i]) != hi(s[i - 1]);
  cnt[tid] = local;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int v = tid >= off ? cnt[tid - off] : 0;
    __syncthreads();
    cnt[tid] += v;
    __syncthreads();
  }
  int run = cnt[tid] - local;  // exclusive offset
  for (int i = lo; i < hi_; ++i) {
    if (i > 0) run += hi(s[i]) != hi(s[i - 1]);
    seg[i] = run;
    perm[i] = static_cast<int64_t>(s[i] & 0xffffffffu);
  }
  __syncthreads();

  // 3. one thread walks each segment from its first sorted position
  for (int i = tid; i < C; i += kThreads) {
    if (i > 0 && hi(s[i]) == hi(s[i - 1])) continue;
    const uint32_t key = hi(s[i]);
    int end = i + 1;
    while (end < C && hi(s[end]) == key) ++end;
    double emin = DBL_MAX;
    for (int j = i; j < end; ++j) {
      const int p = static_cast<int>(s[j] & 0xffffffffu);
      if (valid[p] && Eng[p] < emin) emin = Eng[p];
    }
    int64_t fmin = C;
    T n_near = T(0), psum = T(0);
    int64_t dsum = 0;
    for (int j = i; j < end; ++j) {
      const int p = static_cast<int>(s[j] & 0xffffffffu);
      if (!valid[p]) continue;
      const double e = Eng[p];
      if (e == emin && fmin == C) fmin = j;
      if (e - emin <= min_dEng) {
        n_near += T(1);
        psum += prob[p];
        dsum += deg[p];
      }
    }
    const int64_t sid = seg[i];
    Emin[sid] = emin;
    first_min[sid] = fmin;
    gprob[sid] = fmin < C ? psum / (n_near > T(1) ? n_near : T(1)) : neg;
    deg_seg[sid] = dsum;
  }
}

template <typename T>
int launch(const void* key1, const void* Eng, const void* prob,
           const void* valid, const void* deg, double min_dEng, double neg,
           int C, void* perm, void* seg, void* Emin, void* first_min,
           void* gprob, void* deg_seg, void* stream) {
  if (C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  int N = 1;
  while (N < C) N <<= 1;
  const size_t smem = sizeof(uint64_t) * N;
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(uint64_t) * kMaxC));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key1), static_cast<const double*>(Eng),
      static_cast<const T*>(prob), static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(deg), min_dEng, T(neg), C, N,
      static_cast<int64_t*>(perm), static_cast<int64_t*>(seg),
      static_cast<double*>(Emin), static_cast<int64_t*>(first_min),
      static_cast<T*>(gprob), static_cast<int64_t*>(deg_seg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tnax_merge_f32(const void* key1, const void* Eng, const void* prob,
                   const void* valid, const void* deg, double min_dEng,
                   double neg, int C, void* perm, void* seg, void* Emin,
                   void* first_min, void* gprob, void* deg_seg,
                   void* stream) {
  return launch<float>(key1, Eng, prob, valid, deg, min_dEng, neg, C, perm,
                       seg, Emin, first_min, gprob, deg_seg, stream);
}

int tnax_merge_f64(const void* key1, const void* Eng, const void* prob,
                   const void* valid, const void* deg, double min_dEng,
                   double neg, int C, void* perm, void* seg, void* Emin,
                   void* first_min, void* gprob, void* deg_seg,
                   void* stream) {
  return launch<double>(key1, Eng, prob, valid, deg, min_dEng, neg, C, perm,
                        seg, Emin, first_min, gprob, deg_seg, stream);
}

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
