// The marginal epilogue's steps 1-4, shared by K3 (marginal.cu, the beam
// search) and K4 (sample.cu, the Gibbs sampler): one warp turns a branch's
// Boltzmann column and its row of T2 into the normalized conditional
// marginals of tnax/engine.py `marginal_step` (after its two GEMMs):
//   1. the column's maximum over all Np states (0 when it is not finite);
//   2. Pn[s] = T2[drindex[s]] * exp(col[s] - max) for the valid states
//      s < nv, 0 beyond;
//   3. the minimum mPn over the valid states; when it is negative, the
//      valid states below |mPn| are clamped to |mPn| and mPn is scaled by
//      their count;
//   4. normalization by the sum, or the uniform row over the valid states
//      when the sum is not positive (mPn = -1 then).
// Every reduction is a warp butterfly, so every lane ends with the same
// bits and no block barrier is needed.
//
// A row of Np states is spread over the warp's 32 lanes; the caller picks
// how (the `Row` types below): which states a lane owns, and whether they
// sit in registers or in shared memory.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace tnax {

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
  __device__ static float lg2(float x) { return log2f(x); }
};

template <>
struct Num<double> {
  __device__ static double ninf() {
    return __longlong_as_double(0xfff0000000000000LL);
  }
  __device__ static double big() { return DBL_MAX; }
  __device__ static double ex(double x) { return exp(x); }
  __device__ static double lg2(double x) { return log2(x); }
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

// Reduce v over the warp; every lane returns the same bits (a + b == b + a).
template <typename T, typename Op>
__device__ T warp_all(T v, Op op) {
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// A row in registers: lane l owns the K consecutive states l*K .. l*K+K-1
// (states >= Np are padding and never read). With every loop over the
// slots unrolled, slot i is a fixed register.
template <typename T, int K>
struct RegRow {
  T v[K];
  int lane;
  __device__ explicit RegRow(int lane_) : lane(lane_) {}
  __device__ static constexpr int slots() { return K; }
  __device__ int state(int i) const { return lane * K + i; }
  __device__ T& at(int i) { return v[i]; }
};

// A row in shared memory, k slots per lane, slot i of lane l at p[32i + l]
// (no bank conflicts). kContiguous: lane l owns the states l*k .. l*k+k-1,
// as RegRow; otherwise the states l, l + 32, l + 64, ...
template <typename T, bool kContiguous>
struct SmemRow {
  T* p;
  int lane, k;
  __device__ SmemRow(T* p_, int lane_, int k_) : p(p_), lane(lane_), k(k_) {}
  __device__ int slots() const { return k; }
  __device__ int state(int i) const {
    return kContiguous ? lane * k + i : lane + 32 * i;
  }
  __device__ T& at(int i) { return p[32 * i + lane]; }
};

// What steps 1-4 leave besides the clamped row: the row's negativeness flag
// (normalized), its sum and the uniform row's value.
template <typename T>
struct Epilogue {
  T mPn;      // the minimum valid marginal, clamp count applied, normalized
  T no;       // the row's sum after the clamp
  T unif;     // 1 / nv
  bool good;  // no > 0: the row normalizes
  // the normalized marginal of state s, whose clamped value is p
  __device__ T pn(T p, int s, int nv) const {
    return good ? p / no : (s < nv ? unif : T(0));
  }
};

// Steps 1-4 for one warp's row: col (Np values, the branch's Boltzmann
// column), t2 (the branch's row of T2), dr (the instance's drindex), nv
// valid states. Leaves the clamped, unnormalized marginal of each owned
// state s < Np in row.at(i); Epilogue::pn normalizes it.
template <typename T, typename Row, typename Idx>
__device__ Epilogue<T> marginal_row(Row& row, const T* __restrict__ col,
                                    const T* __restrict__ t2,
                                    const Idx* __restrict__ dr, int Np,
                                    int nv) {
  // 1. the Boltzmann column and its maximum over all Np states
  T lmax = Num<T>::ninf();
#pragma unroll
  for (int i = 0; i < row.slots(); ++i) {
    const int s = row.state(i);
    if (s < Np) {
      const T x = col[s];
      row.at(i) = x;
      lmax = Max()(lmax, x);
    }
  }
  T shift = warp_all(lmax, Max());
  if (!(shift >= -Num<T>::big() && shift <= Num<T>::big()))
    shift = T(0);  // not finite

  // 2-3. the masked marginals, their minimum, the clamp
  T lmin = Num<T>::big();
#pragma unroll
  for (int i = 0; i < row.slots(); ++i) {
    const int s = row.state(i);
    if (s < Np) {
      const T p = s < nv ? t2[dr[s]] * Num<T>::ex(row.at(i) - shift) : T(0);
      row.at(i) = p;
      if (s < nv) lmin = Min()(lmin, p);
    }
  }
  Epilogue<T> e;
  e.mPn = warp_all(lmin, Min());
  const bool neg = e.mPn < T(0);
  const T amin = neg ? -e.mPn : e.mPn;
  int lclip = 0;
  T lsum = T(0);
#pragma unroll
  for (int i = 0; i < row.slots(); ++i) {
    const int s = row.state(i);
    if (s < Np) {
      T p = row.at(i);
      if (neg && s < nv && p < amin) {
        p = amin;
        row.at(i) = p;
        ++lclip;
      }
      lsum += p;
    }
  }
  const int nclip = warp_all(lclip, Sum());
  e.no = warp_all(lsum, Sum());
  if (neg) e.mPn *= static_cast<T>(nclip);

  // 4. normalization, or the uniform row
  e.good = e.no > T(0);
  e.mPn = e.good ? e.mPn / e.no : T(-1);
  e.unif = T(1) / static_cast<T>(nv);
  return e;
}

}  // namespace tnax
