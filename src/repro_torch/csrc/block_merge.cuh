// The host driver's per-block top-k merge as device routines (CUDA C++
// for sm_90a): the body of the standalone merge kernel (block_merge.cu)
// and of the merge epilogue of K5's masked entry (dtw.cu).
//
// For one block of nb candidate rows starting at database row `lo`, with
// K4's stage (Q, nb) and K5's DP values dvals (Q, nb), read only where the
// stage is `live`, the pipeline's number of LB stages: stage s < live is
// a pair pruned by LB stage s (2 stages: LB_Keogh, LB_Improved; 3: LB_Kim
// first), `live` a survivor, 255 a pad row:
//   * query q's top-k (top_v, top_i, ascending) takes the block's
//     survivors as a stable sort of [top-k, survivors in row order] would:
//     on equal values the earlier position wins, so an entry already in
//     the top-k beats a new one and a lower row beats a higher one;
//   * counts (live + 1, Q) += the pairs pruned by each LB stage and the
//     survivors of each query;
//   * totals (4,) += [any real pair survived the first LB stage (a stage
//     from 1 to 254), ceil(S / dtw_chunk),
//     dtw_chunk * ceil(S / dtw_chunk), S] with S the block's survivors:
//     blocks_lb2, blocks_dtw, dp_lane_work and dp_lane_useful of the
//     host loop that pooled the survivors into dtw_chunk-sized launches.
//
// merge_query is one query on one warp: it reads the stage 32 slots at a
// time, counts with ballots, and inserts each survivor below the k-th
// value in row order, lane 0 shifting the larger entries down.  The
// totals depend on the stage alone (add_block_totals), so any one warp
// can add them, before, after or while the queries are merged.
#pragma once

#include "common.cuh"

namespace repro {

// Where a block's merge writes, and how.
template <typename T> struct MergeOut {
  T* top_v;         // (Q, k), ascending; nullptr: no merge
  int64_t* top_i;   // (Q, k)
  int64_t* counts;  // (live + 1, Q)
  int64_t* totals;  // (4,)
  int k;
  int dtw_chunk;
  int64_t lo;       // database row of the block's first candidate
  int live;         // the survivors' stage: the number of LB stages, 1..3
};

// Merge query q of nq on one warp (every lane calls it; lane 0 writes).
// The DP values are read through L2 (__ldcg), all 32 slots of a step at
// once, whatever their stage: in the epilogue of K5's masked entry other
// blocks of the same launch have just written them.
template <typename T>
__device__ void merge_query(const MergeOut<T>& m, const uint8_t* __restrict__ stage,
                            const T* dvals, int64_t nq, int64_t nb, int64_t q, int lane) {
  T* tv = m.top_v + q * m.k;
  int64_t* ti = m.top_i + q * m.k;
  const uint8_t* st = stage + q * nb;
  const T* dv = dvals + q * nb;
  int64_t pruned[3] = {0, 0, 0}, survivors = 0;
  T kth = tv[m.k - 1];
  for (int64_t b0 = 0; b0 < nb; b0 += 32) {
    const int64_t b = b0 + lane;
    const int s = b < nb ? st[b] : 255;
    const T raw = b < nb ? __ldcg(dv + b) : T(0);  // a dead slot's value is never used
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < m.live) pruned[j] += __popc(__ballot_sync(0xffffffffu, s == j));
    unsigned live = __ballot_sync(0xffffffffu, s == m.live);
    survivors += __popc(live);
    const T v = s == m.live ? raw : T(0);
    while (live) {  // survivors in row order
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const T cv = __shfl_sync(0xffffffffu, v, src);
      if (cv < kth) {  // the same in every lane
        T nk = cv;  // the new k-th: cv, or the old (k-1)-th if that moves down
        if (lane == 0) {
          int pos = m.k - 1;  // the old k-th entry drops out
          while (pos > 0) {
            const T prev = tv[pos - 1];
            if (!(prev > cv)) break;
            if (pos == m.k - 1) nk = prev;
            tv[pos] = prev;
            ti[pos] = ti[pos - 1];
            --pos;
          }
          tv[pos] = cv;
          ti[pos] = m.lo + b0 + src;
        }
        kth = __shfl_sync(0xffffffffu, nk, 0);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < m.live) m.counts[j * nq + q] += pruned[j];
    m.counts[m.live * nq + q] += survivors;
  }
}

// The block's totals from its whole stage (nslots = Q * nb values) on
// one warp: S survivors (stage m.live) and whether any real pair reached
// the second LB stage (a stage from 1 to 254).  Integers only, so it
// matters not when or where it runs.  Not inlined, so K5's instances
// share one copy per T.
template <typename T>
__device__ __noinline__ void add_block_totals(const MergeOut<T>& m, const uint8_t* __restrict__ stage,
                                 int64_t nslots, int lane) {
  int64_t s = 0;
  bool reached = false;
#pragma unroll 4
  for (int64_t i = lane; i < nslots; i += 32) {
    const int v = stage[i];
    s += v == m.live;
    reached |= v >= 1 && v < 255;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  reached = __any_sync(0xffffffffu, reached);
  if (lane == 0) {
    const int64_t chunks = (s + m.dtw_chunk - 1) / m.dtw_chunk;
    m.totals[0] += reached ? 1 : 0;
    m.totals[1] += chunks;
    m.totals[2] += chunks * m.dtw_chunk;
    m.totals[3] += s;
  }
}

}  // namespace repro
