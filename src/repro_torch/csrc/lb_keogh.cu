// K2: query-major LB_Keogh and the projection H, and K7, its stream form
// (CUDA C++ for sm_90a).
//
// Replaces the TPU kernels repro/kernels/lb_keogh/kernel.py:
// lb_keogh_qbatch_pallas (_lb_keogh_qbatch_kernel), its single-query form
// lb_keogh_pallas (_lb_keogh_kernel) as the Q = 1 case, and
// lb_keogh_stream_qbatch_pallas (_lb_keogh_stream_qbatch_kernel) as the
// strided entry repro_lb_keogh_stream.
//
// For each (query q, candidate c) pair:
//   lb[pair] = sum_i (max(c_i - U_q,i, 0) + max(L_q,i - c_i, 0))^p
//              (the max of the terms at p = inf), and
//   H[pair]  = clip(c, L_q, U_q), the projection LB_Improved's pass 2 reads.
// The reference computes d**p, which is inf at p = inf; this kernel uses
// the max form there, as repro.core.lb.lb_keogh_powered does.
//
// Bound on this card: bytes.  Writing H (one row of n values per pair)
// dominates; each pair does a handful of operations per value.  At the
// host driver's blocks (hundreds of pairs) nothing fills the card, and the
// time is one pair's chain of loads.
// Design: one warp per pair (lb_routines.cuh: keogh_pair_batched), `warps`
// pairs per block (the tune knob tile_b; it changes no reduction order).
// Each lane keeps the element order of keogh_pair (lane l adds l, l + 32,
// ..., so lb is bit-equal to K4's pass 1) but issues the loads of
// KEOGH_BATCH elements before their arithmetic, so a pair's chain is
// n / (32 KEOGH_BATCH) round trips to memory instead of n / 32.  Pairs
// are numbered query-major, so a block's warps mostly share one query and
// its U, L rows (8 KB at n = 1,000) come from L1 through the read-only
// path: no staging and no block barrier, and the pair-list entry, whose
// warps may each have another query, runs the same code.  H is written
// with streaming stores: it is read once, by K3, and should not push the
// candidate rows out of L2.  No row is held in shared memory, so no
// length is refused.  Pairs are either the dense (Q, B) grid
// (qidx == nullptr: pair = q * B + c) or explicit (qidx, cidx) lists, so
// one entry serves the dense stage and the compacted per-pair stage.
// Candidate row c starts at cands + c * cstride: cstride = n for a (B, n)
// batch, and the hop for the windows of a flat stream segment (K7), which
// are never copied out of it.
//
// K7's channel entry (K7c, repro_lb_keogh_stream_mv) serves a d-channel
// stream: the segment is (d, L), one row per channel (row stride
// cstride >= L), and window b's flat row of d * n values is, at index j,
// segment[j / n][b * hop + j % n], the channel-major layout of the
// templates' envelopes (Q, d * n).  It runs keogh_pair_batched over that
// flat row (CH: the loads follow the channel rows), so lb and H are
// bit-equal to K2 on the gathered (B, d * n) tile.  The reference has no
// kernel at d > 1: its scanner copies the windows and runs K2's function
// on them (repro/stream/subsequence.py).  d = 1 launches K7 unchanged.
#include "lb_routines.cuh"

namespace repro {

template <typename T, int P>
__global__ void lb_keogh_kernel(const T* __restrict__ cands,
                                const T* __restrict__ upper,
                                const T* __restrict__ lower,
                                const int64_t* __restrict__ qidx,
                                const int64_t* __restrict__ cidx, int64_t npairs,
                                int64_t bstride, int64_t cstride, int n,
                                T* __restrict__ lb, T* __restrict__ h) {
  const int lane = threadIdx.x & 31;
  const int64_t pair = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= npairs) return;
  const int64_t q = qidx ? qidx[pair] : pair / bstride;
  const int64_t c = cidx ? cidx[pair] : pair % bstride;
  const T acc = keogh_pair_batched<T, P>(cands + c * cstride, upper + q * n,
                                         lower + q * n, h + pair * n, n, lane);
  if (lane == 0) lb[pair] = acc;
}

// K7c: window b of a (d, L) segment against query q; pair = q * nb + b.
template <typename T, int P>
__global__ void lb_keogh_stream_mv_kernel(const T* __restrict__ segment,
                                          const T* __restrict__ upper,
                                          const T* __restrict__ lower, int64_t npairs,
                                          int64_t nb, int64_t hop, int64_t cstride, int n,
                                          int d, T* __restrict__ lb, T* __restrict__ h) {
  const int lane = threadIdx.x & 31;
  const int64_t pair = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= npairs) return;
  const int64_t q = pair / nb, b = pair % nb;
  const int flat = d * n;
  const T acc = keogh_pair_batched<T, P, true>(segment + b * hop, upper + q * flat,
                                               lower + q * flat, h + pair * flat, flat,
                                               lane, n, cstride);
  if (lane == 0) lb[pair] = acc;
}

// The warps a block of `kernel` may hold: `warps`, capped at what the
// kernel's registers allow (the float64 batches of loads take more than 64
// a thread, so not 32 warps); fewer warps a block change no output bit.
// No launch bound instead: one (1,024) slowed the float32 kernel by 8-16%
// (tools/ab_lb_pass.py).  `max_warps` caches the cap per kernel.
template <typename Kernel>
cudaError_t cap_warps(Kernel kernel, int& warps, int& max_warps) {
  if (warps < 1 || warps > 32) return cudaErrorInvalidValue;
  if (max_warps == 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    max_warps = attr.maxThreadsPerBlock / 32;
  }
  if (warps > max_warps) warps = max_warps;
  return cudaSuccess;
}

template <typename T, int P>
cudaError_t launch_lb_keogh_stream_mv(const T* segment, const T* upper, const T* lower,
                                      int64_t nq, int64_t nb, int64_t hop,
                                      int64_t cstride, int n, int d, int warps, T* lb,
                                      T* h, cudaStream_t s) {
  static int max_warps = 0;
  const cudaError_t err = cap_warps(lb_keogh_stream_mv_kernel<T, P>, warps, max_warps);
  if (err != cudaSuccess) return err;
  const int64_t npairs = nq * nb;
  const unsigned blocks = (unsigned)((npairs + warps - 1) / warps);
  lb_keogh_stream_mv_kernel<T, P><<<blocks, 32 * warps, 0, s>>>(
      segment, upper, lower, npairs, nb, hop, cstride, n, d, lb, h);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_lb_keogh(const T* cands, const T* upper, const T* lower,
                            const int64_t* qidx, const int64_t* cidx,
                            int64_t npairs, int64_t bstride, int64_t cstride,
                            int n, int warps, T* lb, T* h, cudaStream_t s) {
  static int max_warps = 0;
  const cudaError_t err = cap_warps(lb_keogh_kernel<T, P>, warps, max_warps);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((npairs + warps - 1) / warps);
  lb_keogh_kernel<T, P><<<blocks, 32 * warps, 0, s>>>(
      cands, upper, lower, qidx, cidx, npairs, bstride, cstride, n, lb, h);
  return cudaGetLastError();
}

}  // namespace repro

// cands (Nc, n); upper, lower (Q, n); lb (npairs,); h (npairs, n).
// Dense mode: qidx = cidx = nullptr and npairs = Q * bstride.
extern "C" int repro_lb_keogh(int dtype, int pcode, const void* cands,
                              const void* upper, const void* lower,
                              const int64_t* qidx, const int64_t* cidx,
                              int64_t npairs, int64_t bstride, int n, int warps,
                              void* lb, void* h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 0) return (int)cudaGetLastError();
  REPRO_DISPATCH(dtype, pcode,
    return (int)repro::launch_lb_keogh<T, P>(
        static_cast<const T*>(cands), static_cast<const T*>(upper),
        static_cast<const T*>(lower), qidx, cidx, npairs, bstride, n, n, warps,
        static_cast<T*>(lb), static_cast<T*>(h), s));
  return (int)cudaGetLastError();
}

// K7: segment (>= (nb - 1) * hop + n values); window b is
// segment[b * hop : b * hop + n].  upper, lower (Q, n); lb (Q, nb);
// h (Q, nb, n).
extern "C" int repro_lb_keogh_stream(int dtype, int pcode, const void* segment,
                                     const void* upper, const void* lower,
                                     int64_t nq, int64_t nb, int64_t hop, int n,
                                     int warps, void* lb, void* h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq * nb == 0) return (int)cudaGetLastError();
  REPRO_DISPATCH(dtype, pcode,
    return (int)repro::launch_lb_keogh<T, P>(
        static_cast<const T*>(segment), static_cast<const T*>(upper),
        static_cast<const T*>(lower), nullptr, nullptr, nq * nb, nb, hop, n,
        warps, static_cast<T*>(lb), static_cast<T*>(h), s));
  return (int)cudaGetLastError();
}

// K7c: segment (d rows of >= (nb - 1) * hop + n values, row stride
// cstride); window b's flat row is segment[j / n][b * hop + j % n] for
// j < d * n.  upper, lower (Q, d * n); lb (Q, nb); h (Q, nb, d * n).
extern "C" int repro_lb_keogh_stream_mv(int dtype, int pcode, const void* segment,
                                        int64_t cstride, const void* upper,
                                        const void* lower, int64_t nq, int64_t nb,
                                        int64_t hop, int n, int d, int warps, void* lb,
                                        void* h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq * nb == 0) return (int)cudaGetLastError();
  if (d < 1 || n < 1) return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, pcode,
    return (int)repro::launch_lb_keogh_stream_mv<T, P>(
        static_cast<const T*>(segment), static_cast<const T*>(upper),
        static_cast<const T*>(lower), nq, nb, hop, cstride, n, d, warps,
        static_cast<T*>(lb), static_cast<T*>(h), s));
  return (int)cudaGetLastError();
}
