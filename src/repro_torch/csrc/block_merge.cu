// The host driver's per-block top-k merge and counters on the device
// (CUDA C++ for sm_90a).
//
// Replaces no TPU kernel: the reference merges on the host
// (repro/core/cascade.py, nn_search_host's `merge`, a stable numpy
// argsort of the query's top-k followed by the chunk's DP values).
//
// The merge itself (block_merge.cuh) is the routine that K5's masked
// entry runs as its epilogue on the host driver's loop (dtw.cu); this
// kernel runs it alone, as the yardstick and check of that routine.
//
// Bound on this card: bytes (the stage, the live values and the top-k);
// the time is one small launch.  Design: one block for the whole query
// batch, one warp per query (warps loop when Q > 32), each running
// merge_query; warp 0 then adds the block's totals from the stage.
#include "block_merge.cuh"

namespace repro {

template <typename T>
__global__ void block_merge_kernel(MergeOut<T> m, const uint8_t* __restrict__ stage,
                                   const T* __restrict__ dvals, int64_t nq,
                                   int64_t nb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int64_t q = warp; q < nq; q += nwarps)
    merge_query(m, stage, dvals, nq, nb, q, lane);
  if (warp == 0) add_block_totals(m, stage, nq * nb, lane);
}

}  // namespace repro

// top_v (Q, k) ascending and top_i (Q, k), updated in place; stage (Q, nb)
// uint8, n_lb (1..3) the survivors' code; dvals (Q, nb); counts
// (n_lb + 1, Q) and totals (4,) int64, added to; k >= 1, dtw_chunk >= 1.
// One block of min(Q, 32) warps.
extern "C" int repro_block_merge(int dtype, void* top_v, int64_t* top_i, int k,
                                 const uint8_t* stage, const void* dvals,
                                 int64_t nq, int64_t nb, int64_t lo, int dtw_chunk,
                                 int n_lb, int64_t* counts, int64_t* totals,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq == 0) return (int)cudaGetLastError();
  if (k < 1 || dtw_chunk < 1 || n_lb < 1 || n_lb > 3) return (int)cudaErrorInvalidValue;
  const unsigned threads = 32 * (unsigned)(nq < 32 ? nq : 32);
  switch (dtype) {
    case 0:
      repro::block_merge_kernel<float><<<1, threads, 0, s>>>(
          repro::MergeOut<float>{static_cast<float*>(top_v), top_i, counts, totals, k,
                                 dtw_chunk, lo, n_lb},
          stage, static_cast<const float*>(dvals), nq, nb);
      break;
    case 1:
      repro::block_merge_kernel<double><<<1, threads, 0, s>>>(
          repro::MergeOut<double>{static_cast<double*>(top_v), top_i, counts, totals, k,
                                  dtw_chunk, lo, n_lb},
          stage, static_cast<const double*>(dvals), nq, nb);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
