// K6: query-major LB_Kim with an entry mask (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/lb_kim/kernel.py:
// lb_kim_qbatch_pallas (_lb_kim_qbatch_kernel).
//
// For each (query q, candidate c) pair, from the four features first,
// last, max and min:
//   d_first = cost(|c_0 - q_0|),  d_last = cost(|c_{n-1} - q_{n-1}|),
//   d_max   = cost(|max c - max q|),  d_min = cost(|min c - min q|),
//   lb = max(d_first + d_last, max(d_max, d_min))   for p in {1, 2},
//   lb = max(d_first, d_last, d_max, d_min)         for p = inf,
// with cost(d) = d, or d * d at p = 2.  Lanes whose entry mask is 0 get
// BIG (1e30), so they stay dead downstream.
//
// Bound on this card: bytes.  Each pair reads its candidate and query rows
// once and writes one value; the work is two max/min reductions.
// Design: one warp per pair, `warps` pairs per block (the tune knob
// tile_b; it changes no result).  Lanes stride both rows and a shuffle
// reduces the four extrema.  Max, min and abs are exact, and the cost
// product and the first + last sum are rounded on their own (no fused
// multiply-add), so the result is bit-equal to the plain version
// (repro.core.lb.lb_kim_powered_qbatch) whatever the reduction order.
#include "common.cuh"

namespace repro {

template <typename T> __device__ __forceinline__ T mul_rn(T a, T b);
template <> __device__ __forceinline__ float mul_rn<float>(float a, float b) { return __fmul_rn(a, b); }
template <> __device__ __forceinline__ double mul_rn<double>(double a, double b) { return __dmul_rn(a, b); }
template <typename T> __device__ __forceinline__ T add_rn(T a, T b);
template <> __device__ __forceinline__ float add_rn<float>(float a, float b) { return __fadd_rn(a, b); }
template <> __device__ __forceinline__ double add_rn<double>(double a, double b) { return __dadd_rn(a, b); }

template <typename T, int P> __device__ __forceinline__ T kim_cost(T a, T b) {
  const T diff = a - b;
  const T d = diff < T(0) ? -diff : diff;
  return P == 2 ? mul_rn(d, d) : d;
}

template <typename T, int P>
__global__ void lb_kim_kernel(const T* __restrict__ cands,
                              const T* __restrict__ qs,
                              const uint8_t* __restrict__ mask, int64_t nq,
                              int64_t nb, int n, T* __restrict__ lb) {
  const int lane = threadIdx.x & 31;
  const int64_t pair = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= nq * nb) return;
  if (mask && !mask[pair]) {
    if (lane == 0) lb[pair] = big<T>();
    return;
  }
  const T* cr = cands + (pair % nb) * n;
  const T* qr = qs + (pair / nb) * n;
  T cmax = -pos_inf<T>(), cmin = pos_inf<T>();
  T qmax = -pos_inf<T>(), qmin = pos_inf<T>();
  for (int i = lane; i < n; i += 32) {
    const T c = cr[i], q = qr[i];
    cmax = tmax(cmax, c);
    cmin = tmin(cmin, c);
    qmax = tmax(qmax, q);
    qmin = tmin(qmin, q);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cmax = tmax(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    cmin = tmin(cmin, __shfl_xor_sync(0xffffffffu, cmin, off));
    qmax = tmax(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
    qmin = tmin(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
  }
  if (lane != 0) return;
  const T d_first = kim_cost<T, P>(cr[0], qr[0]);
  const T d_last = kim_cost<T, P>(cr[n - 1], qr[n - 1]);
  const T d_ext = tmax(kim_cost<T, P>(cmax, qmax), kim_cost<T, P>(cmin, qmin));
  lb[pair] = P == 0 ? tmax(tmax(d_first, d_last), d_ext)
                    : tmax(add_rn(d_first, d_last), d_ext);
}

}  // namespace repro

// cands (B, n); qs (Q, n); mask (Q, B) bytes or nullptr (all live);
// lb (Q, B).
extern "C" int repro_lb_kim(int dtype, int pcode, const void* cands,
                            const void* qs, const uint8_t* mask, int64_t nq,
                            int64_t nb, int n, int warps, void* lb,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq * nb == 0) return (int)cudaGetLastError();
  if (warps < 1 || warps > 32) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((nq * nb + warps - 1) / warps);
  REPRO_DISPATCH(dtype, pcode,
    repro::lb_kim_kernel<T, P><<<blocks, 32 * warps, 0, s>>>(
        static_cast<const T*>(cands), static_cast<const T*>(qs), mask, nq, nb,
        n, static_cast<T*>(lb)));
  return (int)cudaGetLastError();
}
