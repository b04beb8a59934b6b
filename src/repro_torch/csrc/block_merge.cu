// The host driver's per-block top-k merge and counters on the device
// (CUDA C++ for sm_90a).
//
// Replaces no TPU kernel: the reference merges on the host
// (repro/core/cascade.py, nn_search_host's `merge`, a stable numpy
// argsort of the query's top-k followed by the chunk's DP values).
//
// For one block of nb candidate rows starting at database row `lo`, with
// K4's stage (Q, nb) (0 pruned by LB_Keogh, 1 by LB_Improved, 2 survivor,
// 255 a pad row) and K5's DP values dvals (Q, nb), read only where the
// stage is 2:
//   * query q's top-k (top_v, top_i, ascending) takes the block's
//     survivors as a stable sort of [top-k, survivors in row order] would:
//     on equal values the earlier position wins, so an entry already in
//     the top-k beats a new one and a lower row beats a higher one;
//   * counts (3, Q) += the pairs pruned by LB_Keogh, by LB_Improved and
//     the survivors of each query;
//   * totals (4,) += [any real pair survived LB_Keogh, ceil(S / dtw_chunk),
//     dtw_chunk * ceil(S / dtw_chunk), S] with S the block's survivors:
//     blocks_lb2, blocks_dtw, dp_lane_work and dp_lane_useful of the
//     host loop that pooled the survivors into dtw_chunk-sized launches.
//
// Bound on this card: bytes (the stage, the live values and the top-k);
// the time is one small launch.  Design: one block for the whole query
// batch, one warp per query (warps loop when Q > 32).  A warp reads the
// stage 32 slots at a time, counts with ballots, and inserts each
// survivor below the k-th value in row order, lane 0 shifting the larger
// entries down.  Block totals go through shared memory, integer only, so
// the result does not depend on the order of the warps.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void block_merge_kernel(T* __restrict__ top_v, int64_t* __restrict__ top_i,
                                   int k, const uint8_t* __restrict__ stage,
                                   const T* __restrict__ dvals, int64_t nq,
                                   int64_t nb, int64_t lo, int dtw_chunk,
                                   int64_t* __restrict__ counts,
                                   int64_t* __restrict__ totals) {
  __shared__ unsigned long long survivors;
  __shared__ int any_lb2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) {
    survivors = 0;
    any_lb2 = 0;
  }
  __syncthreads();
  for (int64_t q = warp; q < nq; q += nwarps) {
    T* tv = top_v + q * k;
    int64_t* ti = top_i + q * k;
    const uint8_t* st = stage + q * nb;
    const T* dv = dvals + q * nb;
    int64_t c0 = 0, c1 = 0, c2 = 0;
    T kth = tv[k - 1];
    for (int64_t b0 = 0; b0 < nb; b0 += 32) {
      const int64_t b = b0 + lane;
      const int s = b < nb ? st[b] : 255;
      c0 += __popc(__ballot_sync(0xffffffffu, s == 0));
      c1 += __popc(__ballot_sync(0xffffffffu, s == 1));
      unsigned live = __ballot_sync(0xffffffffu, s == 2);
      c2 += __popc(live);
      const T v = s == 2 ? dv[b] : T(0);
      while (live) {  // survivors in row order
        const int src = __ffs(live) - 1;
        live &= live - 1;
        const T cv = __shfl_sync(0xffffffffu, v, src);
        if (cv < kth) {  // the same in every lane
          T nk = kth;
          if (lane == 0) {
            int pos = k - 1;  // the old k-th entry drops out
            while (pos > 0 && tv[pos - 1] > cv) {
              tv[pos] = tv[pos - 1];
              ti[pos] = ti[pos - 1];
              --pos;
            }
            tv[pos] = cv;
            ti[pos] = lo + b0 + src;
            nk = tv[k - 1];
          }
          kth = __shfl_sync(0xffffffffu, nk, 0);
        }
      }
    }
    if (lane == 0) {
      counts[q] += c0;
      counts[nq + q] += c1;
      counts[2 * nq + q] += c2;
      atomicAdd(&survivors, (unsigned long long)c2);
      if (c1 + c2 > 0) any_lb2 = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int64_t s = (int64_t)survivors;
    const int64_t chunks = (s + dtw_chunk - 1) / dtw_chunk;
    totals[0] += any_lb2;
    totals[1] += chunks;
    totals[2] += chunks * dtw_chunk;
    totals[3] += s;
  }
}

}  // namespace repro

// top_v (Q, k) ascending and top_i (Q, k), updated in place; stage (Q, nb)
// uint8; dvals (Q, nb); counts (3, Q) and totals (4,) int64, added to;
// k >= 1, dtw_chunk >= 1.  One block of min(Q, 32) warps.
extern "C" int repro_block_merge(int dtype, void* top_v, int64_t* top_i, int k,
                                 const uint8_t* stage, const void* dvals,
                                 int64_t nq, int64_t nb, int64_t lo, int dtw_chunk,
                                 int64_t* counts, int64_t* totals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq == 0) return (int)cudaGetLastError();
  if (k < 1 || dtw_chunk < 1) return (int)cudaErrorInvalidValue;
  const unsigned threads = 32 * (unsigned)(nq < 32 ? nq : 32);
  switch (dtype) {
    case 0:
      repro::block_merge_kernel<float><<<1, threads, 0, s>>>(
          static_cast<float*>(top_v), top_i, k, stage,
          static_cast<const float*>(dvals), nq, nb, lo, dtw_chunk, counts, totals);
      break;
    case 1:
      repro::block_merge_kernel<double><<<1, threads, 0, s>>>(
          static_cast<double*>(top_v), top_i, k, stage,
          static_cast<const double*>(dvals), nq, nb, lo, dtw_chunk, counts, totals);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
