// K2: query-major LB_Keogh and the projection H (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/lb_keogh/kernel.py:
// lb_keogh_qbatch_pallas (_lb_keogh_qbatch_kernel), and its single-query
// form lb_keogh_pallas (_lb_keogh_kernel) as the Q = 1 case.
//
// For each (query q, candidate c) pair:
//   lb[pair] = sum_i (max(c_i - U_q,i, 0) + max(L_q,i - c_i, 0))^p
//              (the max of the terms at p = inf), and
//   H[pair]  = clip(c, L_q, U_q), the projection LB_Improved's pass 2 reads.
// The reference computes d**p, which is inf at p = inf; this kernel uses
// the max form there, as repro.core.lb.lb_keogh_powered does.
//
// Bound on this card: bytes.  Writing H (one row of n values per pair)
// dominates; each pair does a handful of operations per value.
// Design: one warp per pair, eight pairs per block.  Pairs are numbered
// query-major, so a block's warps mostly share one query and its U, L rows
// come from L1.  Lanes stride the row (coalesced loads and H stores) and a
// warp shuffle reduces lb.  Pairs are either the dense (Q, B) grid
// (qidx == nullptr: pair = q * B + c) or explicit (qidx, cidx) lists, so
// one entry serves the dense stage and the compacted per-pair stage.
#include "common.cuh"

namespace repro {

constexpr int KEOGH_WARPS = 8;

template <typename T, int P>
__global__ void lb_keogh_kernel(const T* __restrict__ cands,
                                const T* __restrict__ upper,
                                const T* __restrict__ lower,
                                const int64_t* __restrict__ qidx,
                                const int64_t* __restrict__ cidx, int64_t npairs,
                                int64_t bstride, int n, T* __restrict__ lb,
                                T* __restrict__ h) {
  const int lane = threadIdx.x & 31;
  const int64_t pair = (int64_t)blockIdx.x * KEOGH_WARPS + (threadIdx.x >> 5);
  if (pair >= npairs) return;
  const int64_t q = qidx ? qidx[pair] : pair / bstride;
  const int64_t c = cidx ? cidx[pair] : pair % bstride;
  const T* cr = cands + c * n;
  const T* ur = upper + q * n;
  const T* lr = lower + q * n;
  T* hr = h + pair * n;
  T acc = T(0);
  for (int i = lane; i < n; i += 32) {
    const T v = cr[i], uu = ur[i], ll = lr[i];
    const T d = tmax(v - uu, T(0)) + tmax(ll - v, T(0));
    acc = combine<T, P>(acc, cost_of<T, P>(d));
    hr[i] = tmin(tmax(v, ll), uu);
  }
  acc = warp_reduce<T, P>(acc);
  if (lane == 0) lb[pair] = acc;
}

}  // namespace repro

// cands (Nc, n); upper, lower (Q, n); lb (npairs,); h (npairs, n).
// Dense mode: qidx = cidx = nullptr and npairs = Q * bstride.
extern "C" int repro_lb_keogh(int dtype, int pcode, const void* cands,
                              const void* upper, const void* lower,
                              const int64_t* qidx, const int64_t* cidx,
                              int64_t npairs, int64_t bstride, int n, void* lb,
                              void* h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      (unsigned)((npairs + repro::KEOGH_WARPS - 1) / repro::KEOGH_WARPS);
  if (npairs == 0) return (int)cudaGetLastError();
  REPRO_DISPATCH(dtype, pcode,
    repro::lb_keogh_kernel<T, P><<<blocks, 32 * repro::KEOGH_WARPS, 0, s>>>(
        static_cast<const T*>(cands), static_cast<const T*>(upper),
        static_cast<const T*>(lower), qidx, cidx, npairs, bstride, n,
        static_cast<T*>(lb), static_cast<T*>(h)));
  return (int)cudaGetLastError();
}
