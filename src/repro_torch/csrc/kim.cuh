// LB_Kim as device routines (CUDA C++ for sm_90a): a row's features, the
// first phase of K6 (lb_kim.cu), and the bound of one (query, candidate)
// pair from the two rows' features, which K6's second phase and K4's kim
// entry (lb_fused.cu) both compute.
//
// A row's features are (first, last, max, min).  A pair's bound is
//   d_first = cost(|c_first - q_first|),  d_last = cost(|c_last - q_last|),
//   d_max   = cost(|c_max - q_max|),      d_min  = cost(|c_min - q_min|),
//   lb = max(d_first + d_last, max(d_max, d_min))   for p in {1, 2},
//   lb = max(d_first, d_last, d_max, d_min)         for p = inf,
// with cost(d) = d, or d * d at p = 2.  Max, min and abs are exact, and
// the product and the first + last sum are rounded on their own (no fused
// multiply-add), so the bound is bit-equal to the plain version
// (repro_torch.core.lb.lb_kim_powered) whatever order the extrema were
// reduced in.
#pragma once

#include "common.cuh"

namespace repro {

// A row's four features, in this order, at feats + 4 * row.
constexpr int KIM_FIRST = 0, KIM_LAST = 1, KIM_MAX = 2, KIM_MIN = 3;
// 16-byte vectors (or single values) a lane loads before it reduces any.
constexpr int KIM_BATCH = 8;

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int width = 4;
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int width = 2;
};

__device__ __forceinline__ void fold(float4 v, float& mx, float& mn) {
  mx = tmax(mx, tmax(tmax(v.x, v.y), tmax(v.z, v.w)));
  mn = tmin(mn, tmin(tmin(v.x, v.y), tmin(v.z, v.w)));
}
__device__ __forceinline__ void fold(double2 v, double& mx, double& mn) {
  mx = tmax(mx, tmax(v.x, v.y));
  mn = tmin(mn, tmin(v.x, v.y));
}

// The max and min of one row of n values on one warp, in every lane.  A
// row whose address is 16-byte aligned is read as 16-byte vectors, the
// n % width values past the last one singly; any other row value by value.
// Each lane issues the loads of KIM_BATCH vectors (or values) before it
// folds the first: at n = 1,000 in float32, 250 vectors, 8 a lane, one
// round trip to memory.  A slot past the row's end loads the lane's first
// slot again, which changes no max or min, so no load waits on a branch.
template <typename T>
__device__ __forceinline__ void row_extrema(const T* __restrict__ row, int n, int lane, T& mx,
                                            T& mn) {
  using V = typename Vec16<T>::type;
  constexpr int WIDTH = Vec16<T>::width;
  mx = -pos_inf<T>();
  mn = pos_inf<T>();
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const V* rv = reinterpret_cast<const V*>(row);
    const int nv = n / WIDTH;
    for (int base = lane; base < nv; base += 32 * KIM_BATCH) {
      V v[KIM_BATCH];
#pragma unroll
      for (int e = 0; e < KIM_BATCH; ++e) {
        const int i = base + 32 * e;
        v[e] = __ldg(rv + (i < nv ? i : base));
      }
#pragma unroll
      for (int e = 0; e < KIM_BATCH; ++e) fold(v[e], mx, mn);
    }
    const int i = nv * WIDTH + lane;
    if (i < n) {
      const T x = __ldg(row + i);
      mx = tmax(mx, x);
      mn = tmin(mn, x);
    }
  } else {
    for (int base = lane; base < n; base += 32 * KIM_BATCH) {
      T v[KIM_BATCH];
#pragma unroll
      for (int e = 0; e < KIM_BATCH; ++e) {
        const int i = base + 32 * e;
        v[e] = __ldg(row + (i < n ? i : base));
      }
#pragma unroll
      for (int e = 0; e < KIM_BATCH; ++e) {
        mx = tmax(mx, v[e]);
        mn = tmin(mn, v[e]);
      }
    }
  }
  mx = warp_reduce<T, 0>(mx);
  mn = warp_min(mn);
}

template <typename T, int P> __device__ __forceinline__ T kim_cost(T a, T b) {
  const T d = fabs(a - b);
  return P == 2 ? mul_rn(d, d) : d;
}

// The powered LB_Kim of one pair from the candidate's features (cf, cl,
// cmax, cmin) and the query's four features at qf.
template <typename T, int P>
__device__ __forceinline__ T kim_bound(T cf, T cl, T cmax, T cmin, const T* qf) {
  const T d_first = kim_cost<T, P>(cf, qf[KIM_FIRST]);
  const T d_last = kim_cost<T, P>(cl, qf[KIM_LAST]);
  const T d_ext = tmax(kim_cost<T, P>(cmax, qf[KIM_MAX]), kim_cost<T, P>(cmin, qf[KIM_MIN]));
  return P == 0 ? tmax(tmax(d_first, d_last), d_ext) : tmax(add_rn(d_first, d_last), d_ext);
}

}  // namespace repro
