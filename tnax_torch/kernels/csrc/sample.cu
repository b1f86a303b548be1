// K4: the Gibbs sampler's whole site step after its two GEMMs, one warp per
// walker (b, m) of a fleet, up to kMaxWarps walkers per block, one launch
// per site.
//
// Replaces, vmapped over the fleet's instances, the site body of
// tnax/parallel.py `sample_rows` after tnax/engine.py `marginal_step`'s two
// GEMMs: the marginal epilogue, the inverse-CDF draw (cums = cumsum(Pn);
// indc = clip(sum(cums < u), 0, nvalid - 1)), the walker's state and
// boundary-index writes, tnax/engine.py `rl_update` and the row's minimum
// of mPn. Warp (b, m)
//   0. reads its boundary indices lidx = vind[b, m, nx] and
//      uidx = vind[b, m, nx + 1];
//   1-4. forms the normalized marginals of its Np states from the column
//      lBT[b, lidx, uidx, :] (epilogue.cuh, shared with K3): lane l holds
//      the consecutive states l*K .. l*K + K - 1 in registers, K = Np / 32
//      rounded up to a power of two (8 at Np = 256), or in shared memory
//      above 512 states;
//   5. draws: a running sum over the lane's states, one warp scan of the
//      lane totals, and the count of cumulative sums below u[b, m] (one
//      warp sum), clipped to [0, nvalid - 1];
//   6. writes states[b, m, col] = indc, vind[b, m, nx] = dmap[b, indc],
//      vind[b, m, nx + 1] = rmap[b, indc] and mPn[b, m];
//   7. RL'[b, m] = RL[b, m] @ AT[b, :, dmap[b, indc], :]: lane j sums the
//      outputs j, j + 32, ... over rows of AT read 32 consecutive values at
//      a time, then the warp's max |entry| rescales them (0 stays 0);
//   8. folds mPn into the instance's running minimum mq[b] with one atomic:
//      min through integer atomics on the value's bits (atomicMin of the
//      signed bits for x >= 0, atomicMax of the unsigned bits for x < 0),
//      exact in any order.
// Walkers never reorder and each is one warp's, so the in-place writes do
// not race; RL' goes to a fresh buffer.
//
// What bounds it on the card: neither bytes nor arithmetic. Per walker it
// reads one Np-state column and Np entries of T2 (2 KB at Np = 256 in
// float32) and does some 15 operations per state plus a D x D GEMV; the
// walker's chain of dependent warp reductions (max, min, count, sum, scan,
// count, max) and gathers is its time. The design keeps that chain short:
// every reduction is a warp shuffle (no block barrier), the row stays in
// registers, the column is read contiguously from the transposed table
// (not one 32-byte sector per state from lB), and the indices are read as
// the sampler holds them, so no cast, gather, scatter or GEMV launch runs
// around it: one launch per site for the whole fleet.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

#include "epilogue.cuh"

namespace {

using tnax::FULL;
using tnax::Max;

constexpr int kMaxWarps = 4;
constexpr int kRegStates = 16;         // states per lane held in registers
constexpr int kRowBytes = 48 * 1024;   // static limit of a block's rows

template <typename T>
struct Args {
  const T* T2;              // (B, M, lhlv) contiguous
  const T* lBT;             // (B, lh, lv, Np), one instance contiguous
  long long lbt_b;          // batch stride
  const int64_t* dr;        // (B, Np), rows contiguous
  long long dr_b;
  const int32_t* dmap;      // (B, Np), rows contiguous
  long long dm_b;
  const int32_t* rmap;
  long long rm_b;
  const int64_t* nvalid;    // (B,)
  long long nv_b;
  const T* u;               // (B, M), rows contiguous
  long long u_b;
  const T* AT;              // (B, D, lv, D), one instance contiguous
  long long at_b;
  const T* RL;              // (B, M, D) contiguous
  int32_t* vind;            // (B, M, W) contiguous, updated in place
  int32_t* states;          // (B, M, L) contiguous, updated in place
  T* RLn;                   // (B, M, D), the new left environments
  T* mPn;                   // (B, M)
  T* mq;                    // (B,) contiguous, updated in place
  int B, M, Np, lv, lhlv, D, W, L, nx, col;
};

__device__ void atomic_min(float* p, float x) {
  x = __fadd_rn(x, 0.0f);  // -0 -> +0, so the sign test below is the order
  if (x >= 0.0f)
    atomicMin(reinterpret_cast<int*>(p), __float_as_int(x));
  else
    atomicMax(reinterpret_cast<unsigned int*>(p), __float_as_uint(x));
}

__device__ void atomic_min(double* p, double x) {
  x = __dadd_rn(x, 0.0);
  if (x >= 0.0)
    atomicMin(reinterpret_cast<long long*>(p), __double_as_longlong(x));
  else
    atomicMax(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(__double_as_longlong(x)));
}

template <typename T, typename Row>
__device__ void site_step(const Args<T>& a, Row& row, long long r, int lane) {
  const int b = static_cast<int>(r / a.M);
  const int m = static_cast<int>(r - static_cast<long long>(b) * a.M);
  const int Np = a.Np;
  // 0-4. the walker's indices, then the marginals
  int32_t* vw = a.vind + r * a.W;
  const int lidx = vw[a.nx], uidx = vw[a.nx + 1];
  const int nv = static_cast<int>(a.nvalid[b * a.nv_b]);
  const T* col = a.lBT + b * a.lbt_b
                 + (static_cast<long long>(lidx) * a.lv + uidx) * Np;
  const tnax::Epilogue<T> e = tnax::marginal_row<T>(
      row, col, a.T2 + r * a.lhlv, a.dr + b * a.dr_b, Np, nv);

  // 5. the draw: the lane's running sums, a warp scan of the lane totals
  T run = T(0);
#pragma unroll
  for (int i = 0; i < row.slots(); ++i) {
    const int s = row.state(i);
    if (s < Np) {
      run += e.pn(row.at(i), s, nv);
      row.at(i) = run;
    }
  }
  T incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const T n = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += n;
  }
  T excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = T(0);
  const T uu = a.u[b * a.u_b + m];
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < row.slots(); ++i) {
    const int s = row.state(i);
    if (s < Np && excl + row.at(i) < uu) ++cnt;
  }
  cnt = __reduce_add_sync(FULL, cnt);
  const int indc = cnt < 0 ? 0 : (cnt > nv - 1 ? nv - 1 : cnt);

  // 6. the walker's writes
  const int d = a.dmap[b * a.dm_b + indc];
  if (lane == 0) {
    a.states[r * a.L + a.col] = indc;
    vw[a.nx] = d;
    vw[a.nx + 1] = a.rmap[b * a.rm_b + indc];
    a.mPn[r] = e.mPn;
    atomic_min(a.mq + b, e.mPn);  // 8.
  }

  // 7. the left environment through the drawn down-leg, rescaled
  const int D = a.D;
  const T* rl = a.RL + r * D;
  const T* at = a.AT + b * a.at_b + static_cast<long long>(d) * D;
  const long long arow = static_cast<long long>(a.lv) * D;
  T* out = a.RLn + r * D;
  T lmax = T(0);
  for (int j = lane; j < D; j += 32) {
    T acc = T(0);
#pragma unroll 8
    for (int k = 0; k < D; ++k) acc += rl[k] * at[k * arow + j];
    out[j] = acc;
    lmax = Max()(lmax, acc < T(0) ? -acc : acc);
  }
  const T scale = tnax::warp_all(lmax, Max());
  if (scale > T(0))
    for (int j = lane; j < D; j += 32) out[j] = out[j] / scale;
}

// K > 0: K states per lane in registers; K == 0: the row in shared memory
template <typename T, int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
site_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long r =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (r >= static_cast<long long>(a.B) * a.M) return;  // the whole warp
  if constexpr (K > 0) {
    tnax::RegRow<T, K> row(lane);
    site_step(a, row, r, lane);
  } else {
    const int k = (a.Np + 31) / 32;
    tnax::SmemRow<T, true> row(
        reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(w) * 32 * k,
        lane, k);
    site_step(a, row, r, lane);
  }
}

template <typename T>
int launch(const Args<T>& a, void* stream) {
  if (a.B < 1 || a.M < 1 || a.Np < 1 || a.D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(a.B) * a.M;
  // spread few walkers over many SMs: one warp per block up to two blocks
  // per SM of the 132, then two, then four
  int nw = rows <= 264 ? 1 : (rows <= 1056 ? 2 : kMaxWarps);
  const int k = (a.Np + 31) / 32;
  const int K = k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8
              : k <= kRegStates ? kRegStates : 0;
  size_t smem = 0;
  if (K == 0) {
    const int per_warp = static_cast<int>(32 * k * sizeof(T));
    if (per_warp > kRowBytes) return static_cast<int>(cudaErrorInvalidValue);
    nw = std::max(1, std::min(nw, kRowBytes / per_warp));
    smem = static_cast<size_t>(nw) * per_warp;
  }
  const long long blocks = (rows + nw - 1) / nw;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks)), block(nw * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: site_kernel<T, 1><<<grid, block, 0, st>>>(a); break;
    case 2: site_kernel<T, 2><<<grid, block, 0, st>>>(a); break;
    case 4: site_kernel<T, 4><<<grid, block, 0, st>>>(a); break;
    case 8: site_kernel<T, 8><<<grid, block, 0, st>>>(a); break;
    case kRegStates:
      site_kernel<T, kRegStates><<<grid, block, 0, st>>>(a);
      break;
    default: site_kernel<T, 0><<<grid, block, smem, st>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define TNAX_SAMPLE_ENTRY(name, T)                                           \
  int name(const void* T2, const void* lBT, long long lbt_b, const void* dr, \
           long long dr_b, const void* dmap, long long dm_b,                 \
           const void* rmap, long long rm_b, const void* nvalid,             \
           long long nv_b, const void* u, long long u_b, const void* AT,     \
           long long at_b, const void* RL, void* vind, void* states,         \
           void* RLn, void* mPn, void* mq, int B, int M, int Np, int lv,     \
           int lhlv, int D, int W, int L, int nx, int col, void* stream) {   \
    const Args<T> a{static_cast<const T*>(T2),                               \
                    static_cast<const T*>(lBT), lbt_b,                       \
                    static_cast<const int64_t*>(dr), dr_b,                   \
                    static_cast<const int32_t*>(dmap), dm_b,                 \
                    static_cast<const int32_t*>(rmap), rm_b,                 \
                    static_cast<const int64_t*>(nvalid), nv_b,               \
                    static_cast<const T*>(u), u_b,                           \
                    static_cast<const T*>(AT), at_b,                         \
                    static_cast<const T*>(RL), static_cast<int32_t*>(vind),  \
                    static_cast<int32_t*>(states), static_cast<T*>(RLn),     \
                    static_cast<T*>(mPn), static_cast<T*>(mq),               \
                    B, M, Np, lv, lhlv, D, W, L, nx, col};                   \
    return launch<T>(a, stream);                                             \
  }

TNAX_SAMPLE_ENTRY(tnax_sample_site_f32, float)
TNAX_SAMPLE_ENTRY(tnax_sample_site_f64, double)

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
