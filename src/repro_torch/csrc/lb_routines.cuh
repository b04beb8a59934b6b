// The two passes of LB_Improved as device routines (CUDA C++ for sm_90a).
//
// keogh_pair is pass 1 of one (query, candidate) pair on one warp: it is
// the body of K2 (lb_keogh.cu, dense, pair-list and stream entries) and of
// K4's pass 1 (lb_fused.cu).  improved_row is pass 2 of one projection
// row on one 256-thread block: it is the body of K3 (lb_improved.cu) and
// of K4's pass 2.  Both kernels of each pass run the same instructions in
// the same order, so K4's lb1 is bit-equal to K2's lb and its lb to K2's
// lb plus K3's lb2, whether the rows live in device or shared memory.
#pragma once

#include "common.cuh"

namespace repro {

// Threads of a pass-2 block; the block reduction's order depends on it.
constexpr int PASS2_THREADS = 256;

// Pass 1 on one warp: lanes stride the row (coalesced), accumulate the
// powered LB_Keogh terms of candidate row cr against the envelope rows
// ur, lr, and write the projection H = clip(c, L, U) to hr.  Returns the
// warp-reduced bound in every lane.
template <typename T, int P>
__device__ __forceinline__ T keogh_pair(const T* __restrict__ cr,
                                        const T* __restrict__ ur,
                                        const T* __restrict__ lr,
                                        T* __restrict__ hr, int n, int lane) {
  T acc = T(0);
  for (int i = lane; i < n; i += 32) {
    const T v = cr[i], uu = ur[i], ll = lr[i];
    const T d = tmax(v - uu, T(0)) + tmax(ll - v, T(0));
    acc = combine<T, P>(acc, cost_of<T, P>(d));
    hr[i] = tmin(tmax(v, ll), uu);
  }
  return warp_reduce<T, P>(acc);
}

// Pass 2 on one block of PASS2_THREADS threads: the band-w envelope of the
// projection row h (n values) by doubling in `buf` (4 * (n + 2w) values),
// then the powered distance of the query row qr to it, reduced across the
// block through `scratch` (32 values).  Every thread gets the result.
template <typename T, int P>
__device__ __forceinline__ T improved_row(const T* h, const T* __restrict__ qr,
                                          int n, int w, T* buf, T* scratch) {
  const SlidingExtrema<T> ext = sliding_extrema(h, n, w, buf);
  T acc = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T v = qr[i];
    const T d = tmax(v - ext.upper(i), T(0)) + tmax(ext.lower(i) - v, T(0));
    acc = combine<T, P>(acc, cost_of<T, P>(d));
  }
  return block_reduce<T, P>(acc, scratch);
}

}  // namespace repro
