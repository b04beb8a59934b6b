// Shared device helpers of the repro_torch kernels (CUDA C++ for sm_90a).
//
// Every kernel is a template on the element type T (float or double) and
// on the norm code P: 1 and 2 are the powered l1/l2 costs, 0 is p = inf
// (costs combined with max instead of sum).  The C entry points take the
// same codes, launch on the caller's stream and return cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace repro {

// Dynamic shared memory one block may use on sm_90 (227 KB); a launcher
// whose buffers would need more takes its long-row path.
// (kernels/common.py SMEM_LIMIT_BYTES repeats it.)
constexpr size_t SMEM_LIMIT = 232448;

// Finite sentinel of the DP (kernels/common.py BIG): inf would poison the
// (min,+) arithmetic with inf - inf.
template <typename T> __device__ __forceinline__ T big() { return T(1.0e30); }

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

template <typename T> __device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T> __device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

// A sum and a product rounded on their own: no fused multiply-add may
// join them, so a kernel keeps the bits of its plain PyTorch version.
template <typename T> __device__ __forceinline__ T add_rn(T a, T b);
template <> __device__ __forceinline__ float add_rn<float>(float a, float b) {
  return __fadd_rn(a, b);
}
template <> __device__ __forceinline__ double add_rn<double>(double a, double b) {
  return __dadd_rn(a, b);
}
template <typename T> __device__ __forceinline__ T mul_rn(T a, T b);
template <> __device__ __forceinline__ float mul_rn<float>(float a, float b) {
  return __fmul_rn(a, b);
}
template <> __device__ __forceinline__ double mul_rn<double>(double a, double b) {
  return __dmul_rn(a, b);
}

// Elementwise cost of a non-negative difference: d, d*d, or d (p = inf).
template <typename T, int P> __device__ __forceinline__ T cost_of(T d) {
  return P == 2 ? d * d : d;
}

// Combine two partial reductions: sum for finite p, max for p = inf.
template <typename T, int P> __device__ __forceinline__ T combine(T a, T b) {
  return P == 0 ? tmax(a, b) : a + b;
}

template <typename T, int P> __device__ __forceinline__ T warp_reduce(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = combine<T, P>(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T> __device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = tmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sliding max and min over the window [i - w, i + w] of one row of n
// values, exact, built in shared memory by doubling: after the level with
// span s, mx[j] = max(x[j .. j + s - 1]) on the row padded with w identity
// values (-inf / +inf) on each side, and mn likewise.  Two lookups at the
// largest span s <= 2w+1 then cover each window (SlidingExtrema::upper /
// lower).  `buf` holds 4 * (n + 2w) values; all threads of the block call
// it, and it ends with a barrier.
template <typename T> struct SlidingExtrema {
  const T* mx;
  const T* mn;
  int span, win;
  __device__ __forceinline__ T upper(int i) const {
    return tmax(mx[i], mx[i + win - span]);  // padded window [i, i + win - 1]
  }
  __device__ __forceinline__ T lower(int i) const {
    return tmin(mn[i], mn[i + win - span]);
  }
};

template <typename T>
__device__ SlidingExtrema<T> sliding_extrema(const T* __restrict__ x, int n,
                                             int w, T* buf) {
  const int lp = n + 2 * w, win = 2 * w + 1;
  T* mx = buf;
  T* mn = buf + lp;
  T* mx2 = buf + 2 * lp;
  T* mn2 = buf + 3 * lp;
  for (int j = threadIdx.x; j < lp; j += blockDim.x) {
    const int src = j - w;
    const bool in = src >= 0 && src < n;
    mx[j] = in ? x[src] : -pos_inf<T>();
    mn[j] = in ? x[src] : pos_inf<T>();
  }
  __syncthreads();
  int span = 1;
  while (2 * span <= win) {
    for (int j = threadIdx.x; j < lp; j += blockDim.x) {
      // positions past the padded row are identity values
      const bool has = j + span < lp;
      mx2[j] = has ? tmax(mx[j], mx[j + span]) : mx[j];
      mn2[j] = has ? tmin(mn[j], mn[j + span]) : mn[j];
    }
    __syncthreads();
    T* t = mx; mx = mx2; mx2 = t;
    t = mn; mn = mn2; mn2 = t;
    span *= 2;
  }
  return SlidingExtrema<T>{mx, mn, span, win};
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro

// Dispatch a templated launch on the dtype code (0 float, 1 double) and the
// norm code (1, 2, 0 = inf); unknown codes return cudaErrorInvalidValue.
#define REPRO_DISPATCH_P(T, pcode, ...)                       \
  switch (pcode) {                                            \
    case 1: { constexpr int P = 1; __VA_ARGS__; break; }      \
    case 2: { constexpr int P = 2; __VA_ARGS__; break; }      \
    case 0: { constexpr int P = 0; __VA_ARGS__; break; }      \
    default: return (int)cudaErrorInvalidValue;               \
  }

#define REPRO_DISPATCH(dtype, pcode, ...)                                   \
  switch (dtype) {                                                          \
    case 0: { using T = float; REPRO_DISPATCH_P(T, pcode, __VA_ARGS__); break; }  \
    case 1: { using T = double; REPRO_DISPATCH_P(T, pcode, __VA_ARGS__); break; } \
    default: return (int)cudaErrorInvalidValue;                             \
  }
