// K2: beam-merge grouping and segment statistics of B instances, for any
// number C of candidates per instance (up to the full expansion M * Np).
//
// Replaces the key1 path of tnax/parallel.py `merge_candidates` (a stable
// jnp.argsort of C int32 keys, a cumsum of key changes, and five jax.ops
// segment reductions), vmapped over the fleet's instances. For row b of
// every (B, C) input and output it
//   1. sorts the keys stably, with the candidate index as payload: an LSD
//      radix sort of 8-bit digits over the key's kb significant bits,
//      ceil(kb / 8) passes (3 at chimera-2048, kb = 19); without kb, 4
//      passes over all 32 bits with the sign bit flipped, so that the
//      unsigned order is the signed one;
//   2. numbers the runs of equal keys (segment ids, a scan of key changes);
//   3. takes per segment: the minimum energy over valid members, the first
//      sorted position holding it, and over the valid members within
//      min_dEng of it their count, the sum of their log2-probabilities and
//      the int64 sum of their degeneracies.
// Outputs are indexed like the plain version's: perm and seg by sorted
// position, the statistics by segment id; ids with no valid member hold
// Emin = DBL_MAX, first_min = C, gprob = NEG, deg = 0. Energies are
// float64 in both instantiations; T is the probability type.
//
// What bounds it on the card: latency, not bytes (some 40 bytes per
// candidate; 0.003 ms of memory traffic even at C = 262,144). The design
// keeps the number of dependent steps small and every step wide:
// - Sort. Each pass is a stable counting sort by one digit. Inside a warp,
//   the 32 elements of a round are ranked among equal digits with
//   __match_any_sync, each warp keeps a running counter per digit, and an
//   exclusive scan over (digit, warp) gives each warp its first slot per
//   digit, so equal keys keep their index order (torch's stable sort).
//   - C <= kSmemC = 4096 (the fleet's caps): one block of 1024 threads per
//     instance; keys and payload stay in shared memory through every pass
//     (96 KB at C = 4096) and the statistics follow in the same launch.
//     Measured on the H100 (device time of one call, B = 1 and 8 alike):
//     0.022 / 0.027 / 0.040 / 0.094 ms at C = 1024 / 2048 / 4096 / 8192,
//     against 0.041 / 0.055 / 0.057 / 0.059 ms for the tiled path, which
//     therefore takes C = 8192 (the main path's cap of 8 * M) and above.
//   - Larger C: tiles of kTile = 2048 over a (tiles, B) grid; each pass is
//     a histogram per tile, an exclusive scan over (digit, tile) per
//     instance, and a scatter ranked as above. Chosen over one thread-block
//     cluster per instance (keys in distributed shared memory) because it
//     holds any C in global memory, fills the card at B = 1 (128 blocks at
//     C = 262,144), and every step is deterministic.
// - Statistics. Two segmented scans over sorted positions: the minimum
//   energy first, since "near" and "first minimum" need it. Each thread
//   folds a contiguous chunk, a block scan combines the chunks (warp
//   shuffles, then the warp totals in order), and tiles are chained by a
//   carry that one thread folds in tile order. A segment's result is
//   written at its last sorted position. Eng, prob, valid and deg are
//   gathered through perm once, into sorted order (coalesced from then on).
// - The order of the probability sums is fixed by C and the tile layout
//   alone, so the same inputs give the same bits on every run. It is not
//   the plain version's sequential order: gprob agrees within a relative
//   2 n eps for a segment of n near members (two orders of the same n-term
//   sum of log2-probabilities, all of one sign). Everything else equals the
//   plain version exactly: min and first position are order-free, and
//   counts and degeneracies are integers.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kRadix = 256;
constexpr int kBlockThreads = 1024;   // one block per instance
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kSmemC = 4096;
constexpr int kTileThreads = 256;     // one block per tile
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTile = 2048;
constexpr int kScanThreads = 1024;
constexpr int kCarryThreads = 256;
constexpr int kCarryChunk = 1024;

// ---------------------------------------------------------------------------
// the sort
// ---------------------------------------------------------------------------

// Where a pass reads its (key, index) pairs in one row: the caller's int32
// keys on the first pass (the index is the position), a buffer later.
struct Src {
  const int32_t* key1;
  uint32_t flip;
  const uint32_t* keys;
  const uint32_t* idx;
  __device__ __forceinline__ void get(int i, uint32_t& k, uint32_t& p) const {
    if (key1 != nullptr) {
      k = static_cast<uint32_t>(key1[i]) ^ flip;
      p = static_cast<uint32_t>(i);
    } else {
      k = keys[i];
      p = idx[i];
    }
  }
};

// The same for every row: key1 with its row stride, or (B, C) buffers.
struct SrcArgs {
  const int32_t* key1;
  long long ld;
  uint32_t flip;
  const uint32_t* keys;
  const uint32_t* idx;
  int C;
  __device__ Src row(int b) const {
    Src s;
    if (key1 != nullptr) {
      s.key1 = key1 + b * ld;
      s.flip = flip;
      s.keys = nullptr;
      s.idx = nullptr;
    } else {
      s.key1 = nullptr;
      s.flip = 0;
      s.keys = keys + static_cast<size_t>(b) * C;
      s.idx = idx + static_cast<size_t>(b) * C;
    }
    return s;
  }
};

// Count the digits of positions [lo, hi) into cnt (this warp's or the
// block's 256 counters).
__device__ void warp_count(const Src& src, int lo, int hi, int shift,
                           int* cnt) {
  for (int i = lo + (threadIdx.x & 31); i < hi; i += 32) {
    uint32_t k, p;
    src.get(i, k, p);
    atomicAdd(&cnt[(k >> shift) & 0xffu], 1);
  }
}

// Scatter positions [lo, hi) in order to their slots: cnt holds this
// warp's next slot per digit; equal digits of one round of 32 are ranked
// by lane.
__device__ void warp_scatter(const Src& src, int lo, int hi, int shift,
                             int* cnt, uint32_t* keys_out,
                             uint32_t* idx_out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool act = i < hi;
    const unsigned mask = __ballot_sync(FULL, act);
    if (act) {
      uint32_t k, p;
      src.get(i, k, p);
      const unsigned d = (k >> shift) & 0xffu;
      const unsigned peers = __match_any_sync(mask, d);
      const int pos = cnt[d] + __popc(peers & below);
      keys_out[pos] = k;
      idx_out[pos] = p;
      __syncwarp(mask);
      if ((peers & below) == 0) cnt[d] += __popc(peers);
    }
    __syncwarp();
  }
}

// Exclusive scan of v over the block in thread order; `total` receives the
// block's sum. `tmp` holds one int per warp.
template <int NT>
__device__ int block_scan_int(int v, int* tmp, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();  // an earlier call may still read tmp
  if (lane == 31) tmp[w] = x;
  __syncthreads();
  int pre = 0;
  total = 0;
  for (int i = 0; i < NT / 32; ++i) {
    const int t = tmp[i];
    if (i < w) pre += t;
    total += t;
  }
  return pre + x - v;
}

// One counting-sort pass of a row of C <= kSmemC elements inside one block:
// warp w takes a contiguous share, cnt is (kBlockWarps, kRadix).
__device__ void block_pass(const Src& src, int C, int shift, int* cnt,
                           int* tmp, uint32_t* keys_out, uint32_t* idx_out) {
  const int tid = threadIdx.x, w = tid >> 5;
  const int per = (C + kBlockWarps - 1) / kBlockWarps;
  const int lo = min(w * per, C), hi = min(lo + per, C);
  for (int j = tid; j < kBlockWarps * kRadix; j += kBlockThreads) cnt[j] = 0;
  __syncthreads();
  warp_count(src, lo, hi, shift, cnt + w * kRadix);
  __syncthreads();
  // exclusive scan in (digit, warp) order: thread t holds digit t / 4 of
  // warps 8 (t % 4) .. 8 (t % 4) + 7
  static_assert(kBlockThreads * 8 == kBlockWarps * kRadix, "scan layout");
  const int d = tid >> 2, w0 = (tid & 3) * 8;
  int v[8];
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = cnt[(w0 + k) * kRadix + d];
    s += v[k];
  }
  int total;
  int pre = block_scan_int<kBlockThreads>(s, tmp, total);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cnt[(w0 + k) * kRadix + d] = pre;
    pre += v[k];
  }
  __syncthreads();
  warp_scatter(src, lo, hi, shift, cnt + w * kRadix, keys_out, idx_out);
  __syncthreads();
}

// Multi-block pass, step 1: the digit counts of each tile, hist[b][d][t].
__global__ void __launch_bounds__(kTileThreads)
tile_hist_kernel(SrcArgs sa, int C, int ntiles, int shift, int* hist) {
  __shared__ int cnt[kRadix];
  static_assert(kTileThreads == kRadix, "one thread per digit");
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  cnt[tid] = 0;
  __syncthreads();
  const Src src = sa.row(b);
  const int lo = t * kTile, hi = min(lo + kTile, C);
  for (int i = lo + tid; i < hi; i += kTileThreads) {
    uint32_t k, p;
    src.get(i, k, p);
    atomicAdd(&cnt[(k >> shift) & 0xffu], 1);
  }
  __syncthreads();
  hist[(static_cast<size_t>(b) * kRadix + tid) * ntiles + t] = cnt[tid];
}

// Step 2: exclusive scan of each instance's n = kRadix * ntiles counts in
// (digit, tile) order, in place.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* hist, int n) {
  __shared__ int tmp[kScanThreads / 32];
  int* h = hist + static_cast<size_t>(blockIdx.x) * n;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int a = min(static_cast<int>(threadIdx.x) * per, n);
  const int e = min(a + per, n);
  int s = 0;
  for (int i = a; i < e; ++i) s += h[i];
  int total;
  int pre = block_scan_int<kScanThreads>(s, tmp, total);
  for (int i = a; i < e; ++i) {
    const int v = h[i];
    h[i] = pre;
    pre += v;
  }
}

// Step 3: each tile's elements to their slots; warp w takes 256
// consecutive positions of the tile.
__global__ void __launch_bounds__(kTileThreads)
tile_scatter_kernel(SrcArgs sa, int C, int ntiles, int shift,
                    const int* hist, uint32_t* keys_out, uint32_t* idx_out) {
  __shared__ int cnt[kTileWarps * kRadix];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, w = tid >> 5;
  for (int j = tid; j < kTileWarps * kRadix; j += kTileThreads) cnt[j] = 0;
  __syncthreads();
  const Src src = sa.row(b);
  const int per = kTile / kTileWarps;
  const int lo = min(t * kTile + w * per, C), hi = min(lo + per, C);
  warp_count(src, lo, hi, shift, cnt + w * kRadix);
  __syncthreads();
  int run = hist[(static_cast<size_t>(b) * kRadix + tid) * ntiles + t];
  for (int k = 0; k < kTileWarps; ++k) {
    const int c = cnt[k * kRadix + tid];
    cnt[k * kRadix + tid] = run;
    run += c;
  }
  __syncthreads();
  const size_t row = static_cast<size_t>(b) * C;
  warp_scatter(src, lo, hi, shift, cnt + w * kRadix, keys_out + row,
               idx_out + row);
}

// ---------------------------------------------------------------------------
// the segment statistics
// ---------------------------------------------------------------------------

// Round 1 of the segmented scan: (a segment starts here, least energy over
// valid members since the last start, number of starts).
struct Min1 {
  bool f;
  double e;
  int nh;
  __device__ static Min1 ident() { return {false, DBL_MAX, 0}; }
  __device__ static Min1 op(const Min1& a, const Min1& b) {
    return {a.f || b.f, b.f ? b.e : (b.e < a.e ? b.e : a.e), a.nh + b.nh};
  }
  __device__ Min1 shfl_up(int off) const {
    return {__shfl_up_sync(FULL, static_cast<int>(f), off) != 0,
            __shfl_up_sync(FULL, e, off), __shfl_up_sync(FULL, nh, off)};
  }
};

// Round 2: (a segment starts here, first position of the minimum, near
// members, their probability sum, their degeneracy sum).
template <typename T>
struct Near2 {
  bool f;
  int fm;
  int n;
  T ps;
  long long ds;
  __device__ static Near2 ident() { return {false, INT_MAX, 0, T(0), 0}; }
  __device__ static Near2 op(const Near2& a, const Near2& b) {
    if (b.f) return b;
    return {a.f, b.fm < a.fm ? b.fm : a.fm, a.n + b.n, a.ps + b.ps,
            a.ds + b.ds};
  }
  __device__ Near2 shfl_up(int off) const {
    return {__shfl_up_sync(FULL, static_cast<int>(f), off) != 0,
            __shfl_up_sync(FULL, fm, off), __shfl_up_sync(FULL, n, off),
            __shfl_up_sync(FULL, ps, off), __shfl_up_sync(FULL, ds, off)};
  }
};

// Exclusive scan of x over the block in thread order with S::op; `total`
// receives the block's fold. The fold order depends on NT alone. `tmp`
// holds one S per warp.
template <int NT, typename S>
__device__ S block_exclusive(const S& x, S* tmp, S& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  S incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const S y = incl.shfl_up(off);
    if (lane >= off) incl = S::op(y, incl);
  }
  S ex = incl.shfl_up(1);
  if (lane == 0) ex = S::ident();
  __syncthreads();  // an earlier call may still read tmp
  if (lane == 31) tmp[w] = incl;
  __syncthreads();
  S pre = S::ident();
  total = S::ident();
  for (int i = 0; i < NT / 32; ++i) {
    if (i == w) pre = total;
    total = S::op(total, tmp[i]);
  }
  return S::op(pre, ex);
}

// Everything the statistics read and write. No pointer here is
// __restrict__: a block reads back what it wrote earlier in the launch.
template <typename T>
struct Stats {
  const double* Eng;
  const T* prob;
  const uint8_t* valid;
  const int64_t* deg;
  long long ld_eng, ld_prob, ld_valid, ld_deg;
  // (B, C) copies in sorted order
  double* Es;
  T* ps;
  uint8_t* vs;
  int64_t* ds;
  // (B, C) outputs
  int64_t* perm;
  int64_t* seg;
  double* Emin;
  int64_t* first_min;
  T* gprob;
  int64_t* deg_seg;
  double min_dEng;
  T neg;
  int C;
};

// One row's sorted elements, by sorted position.
template <typename T>
struct Row {
  const uint32_t* keys;
  const double* E;
  const uint8_t* v;
  const T* p;
  const int64_t* d;
  int64_t* seg;
  double* Emin;
  int64_t* first_min;
  T* gprob;
  int64_t* deg_seg;
  int C;
  __device__ bool head(int i) const { return i == 0 || keys[i] != keys[i - 1]; }
  __device__ bool last(int i) const {
    return i == C - 1 || keys[i + 1] != keys[i];
  }
};

template <typename T>
__device__ Row<T> row_of(const Stats<T>& st, int b, const uint32_t* keys) {
  const size_t o = static_cast<size_t>(b) * st.C;
  return {keys, st.Es + o, st.vs + o, st.ps + o, st.ds + o, st.seg + o,
          st.Emin + o, st.first_min + o, st.gprob + o, st.deg_seg + o, st.C};
}

// Gather positions [lo, hi) of row b through the sorted index into sorted
// order, write perm, and reset the statistics' slots.
template <int NT, typename T>
__device__ void stage(const Stats<T>& st, int b, const uint32_t* idx, int lo,
                      int hi) {
  const size_t o = static_cast<size_t>(b) * st.C;
  for (int i = lo + threadIdx.x; i < hi; i += NT) {
    const uint32_t p = idx[i];
    st.Es[o + i] = st.Eng[b * st.ld_eng + p];
    st.ps[o + i] = st.prob[b * st.ld_prob + p];
    st.vs[o + i] = st.valid[b * st.ld_valid + p];
    st.ds[o + i] = st.deg[b * st.ld_deg + p];
    st.perm[o + i] = p;
    st.Emin[o + i] = DBL_MAX;
    st.first_min[o + i] = st.C;
    st.gprob[o + i] = st.neg;
    st.deg_seg[o + i] = 0;
  }
}

// Round 1 over positions [lo, hi) of a row, after `carry` (the fold of the
// positions before lo). With `write`, sets seg and, at each segment's last
// position, Emin. Returns the fold of [lo, hi) alone.
template <int NT, typename T>
__device__ Min1 round1(const Row<T>& r, int lo, int hi, Min1 carry,
                       bool write, Min1* tmp) {
  const int per = (hi - lo + NT - 1) / NT;
  const int a = min(lo + static_cast<int>(threadIdx.x) * per, hi);
  const int e = min(a + per, hi);
  auto elem = [&](int i) {
    const bool h = r.head(i);
    return Min1{h, r.v[i] ? r.E[i] : DBL_MAX, h ? 1 : 0};
  };
  Min1 agg = Min1::ident();
  for (int i = a; i < e; ++i) agg = Min1::op(agg, elem(i));
  Min1 total;
  Min1 run = Min1::op(carry, block_exclusive<NT>(agg, tmp, total));
  if (write) {
    for (int i = a; i < e; ++i) {
      run = Min1::op(run, elem(i));
      const int s = run.nh - 1;
      r.seg[i] = s;
      if (r.last(i)) r.Emin[s] = run.e;
    }
  }
  return total;
}

// Round 2 likewise (needs seg and Emin of round 1). With `write`, sets
// first_min, gprob and deg_seg at each segment's last position.
template <int NT, typename T>
__device__ Near2<T> round2(const Row<T>& r, int lo, int hi, double min_dEng,
                           T neg, Near2<T> carry, bool write, Near2<T>* tmp) {
  const int per = (hi - lo + NT - 1) / NT;
  const int a = min(lo + static_cast<int>(threadIdx.x) * per, hi);
  const int e = min(a + per, hi);
  auto elem = [&](int i) {
    const double em = r.Emin[r.seg[i]];
    const bool ok = r.v[i] != 0;
    const double en = r.E[i];
    const bool near = ok && en - em <= min_dEng;
    Near2<T> x;
    x.f = r.head(i);
    x.fm = ok && en == em ? i : INT_MAX;
    x.n = near ? 1 : 0;
    x.ps = near ? r.p[i] : T(0);
    x.ds = near ? r.d[i] : 0;
    return x;
  };
  Near2<T> agg = Near2<T>::ident();
  for (int i = a; i < e; ++i) agg = Near2<T>::op(agg, elem(i));
  Near2<T> total;
  Near2<T> run = Near2<T>::op(carry, block_exclusive<NT>(agg, tmp, total));
  if (write) {
    for (int i = a; i < e; ++i) {
      run = Near2<T>::op(run, elem(i));
      if (r.last(i)) {
        const int64_t s = r.seg[i];
        const bool found = run.fm < r.C;
        r.first_min[s] = found ? run.fm : r.C;
        r.gprob[s] = found ? run.ps / (run.n > 1 ? static_cast<T>(run.n) : T(1))
                           : neg;
        r.deg_seg[s] = run.ds;
      }
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// C <= kSmemC: one block per instance, one launch
// ---------------------------------------------------------------------------

// Dynamic shared memory of the one-block path: the digit counters, then
// keys and index twice.
size_t block_smem(int C) {
  return sizeof(uint32_t) * (kBlockWarps * kRadix + 4 * static_cast<size_t>(C));
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
merge_block_kernel(SrcArgs sa, Stats<T> st, int passes) {
  extern __shared__ uint32_t sm[];
  __shared__ int tmp[kBlockWarps];
  __shared__ Min1 tmp1[kBlockWarps];
  __shared__ Near2<T> tmp2[kBlockWarps];
  const int b = blockIdx.x, C = st.C;
  int* cnt = reinterpret_cast<int*>(sm);
  uint32_t* buf[2][2] = {{sm + kBlockWarps * kRadix,
                          sm + kBlockWarps * kRadix + C},
                         {sm + kBlockWarps * kRadix + 2 * C,
                          sm + kBlockWarps * kRadix + 3 * C}};
  Src src = sa.row(b);
  for (int q = 0; q < passes; ++q) {
    uint32_t* ko = buf[q & 1][0];
    uint32_t* io = buf[q & 1][1];
    block_pass(src, C, 8 * q, cnt, tmp, ko, io);
    src.key1 = nullptr;
    src.keys = ko;
    src.idx = io;
  }
  stage<kBlockThreads>(st, b, src.idx, 0, C);
  __syncthreads();
  const Row<T> r = row_of(st, b, src.keys);
  round1<kBlockThreads>(r, 0, C, Min1::ident(), true, tmp1);
  __syncthreads();
  round2<kBlockThreads>(r, 0, C, st.min_dEng, st.neg, Near2<T>::ident(),
                        true, tmp2);
}

// ---------------------------------------------------------------------------
// C > kSmemC: the statistics over a (tiles, B) grid
// ---------------------------------------------------------------------------

// Stage the tile and fold it for round 1: agg1[b][t].
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
stage_kernel(Stats<T> st, const uint32_t* keys, const uint32_t* idx,
             int ntiles, Min1* agg1) {
  __shared__ Min1 tmp1[kTileWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  const int lo = t * kTile, hi = min(lo + kTile, st.C);
  const size_t o = static_cast<size_t>(b) * st.C;
  stage<kTileThreads>(st, b, idx + o, lo, hi);
  __syncthreads();
  const Min1 total = round1<kTileThreads>(row_of(st, b, keys + o), lo, hi,
                                          Min1::ident(), false, tmp1);
  if (threadIdx.x == 0) agg1[static_cast<size_t>(b) * ntiles + t] = total;
}

// carry[b][t] = the fold of agg[b][0..t-1], taken by one thread in tile
// order (the same order as the one-block path would take it).
template <typename S>
__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(const S* agg, S* carry, int ntiles) {
  __shared__ S buf[kCarryChunk];
  const size_t o = static_cast<size_t>(blockIdx.x) * ntiles;
  S run = S::ident();
  for (int base = 0; base < ntiles; base += kCarryChunk) {
    const int n = min(kCarryChunk, ntiles - base);
    for (int k = threadIdx.x; k < n; k += kCarryThreads)
      buf[k] = agg[o + base + k];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < n; ++k) {
        carry[o + base + k] = run;
        run = S::op(run, buf[k]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
round1_kernel(Stats<T> st, const uint32_t* keys, int ntiles,
              const Min1* carry1) {
  __shared__ Min1 tmp1[kTileWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  const int lo = t * kTile, hi = min(lo + kTile, st.C);
  const size_t o = static_cast<size_t>(b) * st.C;
  round1<kTileThreads>(row_of(st, b, keys + o), lo, hi,
                       carry1[static_cast<size_t>(b) * ntiles + t], true,
                       tmp1);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
round2_kernel(Stats<T> st, const uint32_t* keys, int ntiles,
              const Near2<T>* carry2, Near2<T>* agg2) {
  __shared__ Near2<T> tmp2[kTileWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  const int lo = t * kTile, hi = min(lo + kTile, st.C);
  const size_t o = static_cast<size_t>(b) * st.C;
  const size_t at = static_cast<size_t>(b) * ntiles + t;
  const Row<T> r = row_of(st, b, keys + o);
  if (agg2 != nullptr) {  // fold only
    const Near2<T> total = round2<kTileThreads>(
        r, lo, hi, st.min_dEng, st.neg, Near2<T>::ident(), false, tmp2);
    if (threadIdx.x == 0) agg2[at] = total;
  } else {
    round2<kTileThreads>(r, lo, hi, st.min_dEng, st.neg, carry2[at], true,
                         tmp2);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Carves the scratch buffer; with base == nullptr it only measures it.
struct Carver {
  char* base;
  size_t used;
  void* take(size_t bytes) {
    void* p = base != nullptr ? base + used : nullptr;
    used += (bytes + 255) / 256 * 256;
    return p;
  }
};

template <typename T>
struct Scratch {
  double* Es;
  T* ps;
  uint8_t* vs;
  int64_t* ds;
  uint32_t* keys[2];
  uint32_t* idx[2];
  int* hist;
  Min1* agg1;
  Min1* carry1;
  Near2<T>* agg2;
  Near2<T>* carry2;
};

int n_tiles(int C) { return (C + kTile - 1) / kTile; }

template <typename T>
size_t plan(int B, int C, char* base, Scratch<T>* s) {
  Carver cv{base, 0};
  const size_t n = static_cast<size_t>(B) * C;
  Scratch<T> x{};
  x.Es = static_cast<double*>(cv.take(n * sizeof(double)));
  x.ps = static_cast<T*>(cv.take(n * sizeof(T)));
  x.vs = static_cast<uint8_t*>(cv.take(n));
  x.ds = static_cast<int64_t*>(cv.take(n * sizeof(int64_t)));
  if (C > kSmemC) {
    const size_t nt = static_cast<size_t>(B) * n_tiles(C);
    for (int j = 0; j < 2; ++j) {
      x.keys[j] = static_cast<uint32_t*>(cv.take(n * sizeof(uint32_t)));
      x.idx[j] = static_cast<uint32_t*>(cv.take(n * sizeof(uint32_t)));
    }
    x.hist = static_cast<int*>(cv.take(nt * kRadix * sizeof(int)));
    x.agg1 = static_cast<Min1*>(cv.take(nt * sizeof(Min1)));
    x.carry1 = static_cast<Min1*>(cv.take(nt * sizeof(Min1)));
    x.agg2 = static_cast<Near2<T>*>(cv.take(nt * sizeof(Near2<T>)));
    x.carry2 = static_cast<Near2<T>*>(cv.take(nt * sizeof(Near2<T>)));
  }
  if (s != nullptr) *s = x;
  return cv.used;
}

template <typename T>
int launch(const void* key1, long long ld_key, const void* Eng,
           long long ld_eng, const void* prob, long long ld_prob,
           const void* valid, long long ld_valid, const void* deg,
           long long ld_deg, double min_dEng, double neg, int C, int B,
           int key_bits, void* perm, void* seg, void* Emin, void* first_min,
           void* gprob, void* deg_seg, void* scratch, void* stream) {
  if (C < 1 || B < 1 || B > 65535 || key_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const int passes = key_bits < 0 ? 4 : (key_bits > 8 ? (key_bits + 7) / 8 : 1);
  const uint32_t flip = key_bits < 0 ? 0x80000000u : 0u;
  Scratch<T> s;
  plan<T>(B, C, static_cast<char*>(scratch), &s);
  Stats<T> st{static_cast<const double*>(Eng), static_cast<const T*>(prob),
              static_cast<const uint8_t*>(valid),
              static_cast<const int64_t*>(deg), ld_eng, ld_prob, ld_valid,
              ld_deg, s.Es, s.ps, s.vs, s.ds,
              static_cast<int64_t*>(perm), static_cast<int64_t*>(seg),
              static_cast<double*>(Emin), static_cast<int64_t*>(first_min),
              static_cast<T*>(gprob), static_cast<int64_t*>(deg_seg),
              min_dEng, static_cast<T>(neg), C};
  const SrcArgs sa0{static_cast<const int32_t*>(key1), ld_key, flip, nullptr,
                    nullptr, C};
  if (C <= kSmemC) {
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          merge_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(block_smem(kSmemC)));
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set = true;
    }
    merge_block_kernel<T><<<B, kBlockThreads, block_smem(C), st_>>>(
        sa0, st, passes);
    return static_cast<int>(cudaGetLastError());
  }
  const int nt = n_tiles(C);
  const dim3 grid(nt, B);
  SrcArgs sa = sa0;
  for (int q = 0; q < passes; ++q) {
    tile_hist_kernel<<<grid, kTileThreads, 0, st_>>>(sa, C, nt, 8 * q,
                                                     s.hist);
    scan_kernel<<<B, kScanThreads, 0, st_>>>(s.hist, kRadix * nt);
    tile_scatter_kernel<<<grid, kTileThreads, 0, st_>>>(
        sa, C, nt, 8 * q, s.hist, s.keys[q & 1], s.idx[q & 1]);
    sa = SrcArgs{nullptr, 0, 0, s.keys[q & 1], s.idx[q & 1], C};
  }
  const uint32_t* keys = sa.keys;
  stage_kernel<T><<<grid, kTileThreads, 0, st_>>>(st, keys, sa.idx, nt,
                                                  s.agg1);
  carry_kernel<Min1><<<B, kCarryThreads, 0, st_>>>(s.agg1, s.carry1, nt);
  round1_kernel<T><<<grid, kTileThreads, 0, st_>>>(st, keys, nt, s.carry1);
  round2_kernel<T><<<grid, kTileThreads, 0, st_>>>(st, keys, nt, nullptr,
                                                   s.agg2);
  carry_kernel<Near2<T>><<<B, kCarryThreads, 0, st_>>>(s.agg2, s.carry2, nt);
  round2_kernel<T><<<grid, kTileThreads, 0, st_>>>(st, keys, nt, s.carry2,
                                                   nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of scratch that a launch of B rows of C candidates needs.
long long tnax_merge_scratch_bytes(int B, int C, int f64) {
  return static_cast<long long>(f64 ? plan<double>(B, C, nullptr, nullptr)
                                    : plan<float>(B, C, nullptr, nullptr));
}

#define TNAX_MERGE_ENTRY(name, T)                                            \
  int name(const void* key1, long long ld_key, const void* Eng,              \
           long long ld_eng, const void* prob, long long ld_prob,            \
           const void* valid, long long ld_valid, const void* deg,           \
           long long ld_deg, double min_dEng, double neg, int C, int B,       \
           int key_bits, void* perm, void* seg, void* Emin, void* first_min, \
           void* gprob, void* deg_seg, void* scratch, void* stream) {        \
    return launch<T>(key1, ld_key, Eng, ld_eng, prob, ld_prob, valid,        \
                     ld_valid, deg, ld_deg, min_dEng, neg, C, B, key_bits,   \
                     perm, seg, Emin, first_min, gprob, deg_seg, scratch,    \
                     stream);                                                \
  }

TNAX_MERGE_ENTRY(tnax_merge_f32, float)
TNAX_MERGE_ENTRY(tnax_merge_f64, double)

const char* tnax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
