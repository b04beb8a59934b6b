// K4: both passes of LB_Improved, one warp per (query, candidate) pair,
// pass 2 predicated on the pruning bound (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/lb_fused/kernel.py:
// lb_fused_qbatch_pallas (_fused_tile_compute; bodies _lb_fused_kernel,
// _lb_fused_db_qb_kernel and _lb_fused_db_bq_kernel).
//
// For each (query q, candidate c) pair, with bound[q] the query's powered
// pruning bound:
//   lb1 = LB_Keogh (pass 1), H = clip(c, L_q, U_q),
//   lb  = lb1 + lb2(H, q) where lb1 < bound[q], else lb1,
// for p in {1, 2}, and optionally the pair's cascade stage: 0 pruned by
// LB_Keogh (lb1 >= bound), 1 pruned by LB_Improved (lb >= bound), 2 a
// survivor, 255 for a candidate at or past `real` (the padded rows of a
// tail block).  H never leaves shared memory, except on the long-row path.
// The kim entry (query features qfeat, (Q, 4), from K6's feature phase) puts
// LB_Kim first: the pair's LB_Kim (kim.cuh kim_bound) from the query's
// features and the candidate's, whose max and min pass 1's sweep takes on
// the way; where it is >= bound the stage is 0 and pass 2 does not run
// (lb = lb1), and the other stages move up by one (1 pruned by LB_Keogh,
// 2 by LB_Improved, 3 a survivor).  Without it (qfeat == nullptr) no bit
// changes.
//
// Bound on this card: bytes (each candidate row read once, two values per
// pair written), far below what the launch and one pair's chain of
// dependent shared-memory passes take at the host driver's shape.
// Design: one warp per pair, on its own slice of shared memory (the H row
// and the envelope buffers, 4 (n + 2w) + n values), with warp barriers
// only, so every live pair of the launch runs pass 2 at once and a dead
// pair (lb1 >= bound) leaves without holding up another warp.  A block
// holds tile_b warps: one block per (query, tile of tile_b candidates)
// (grid "qb"), or one block per tile whose warps each stage their
// candidate row once and loop over the queries (grid "bq").  Pass 1 is
// keogh_pair (K2's terms in K2's order) and pass 2 improved_pair, which
// builds the envelope of H by chunks (each lane scans one of 32 chunks; no
// doubling levels, so a live pair's chain is short; a band narrower than a
// chunk is scanned directly on the row) and adds K3's terms in K3's order
// (lb_routines.cuh), so lb1 is bit-equal to K2's lb and lb to K2's lb
// plus K3's lb2 under every schedule.  A ragged last tile is
// masked, never padded: no pad lane can keep pass 2 alive.  The bounds
// are read with a stride, so a caller can pass a column of its top-k.
// Long rows, whose one warp's buffers overflow a block's shared memory,
// take the long-row path by shape: H and the pass-2 buffers in a slice of
// a workspace per warp of the grid (which the wrapper's prepared launcher
// allocates once), pass 2 K3's own routine (env_scan.cuh envelope_join,
// then improved_terms), any tile_b.  The kim entry is a runtime argument,
// the same in every warp, so it adds no kernel instantiation: each kernel
// holds both bodies and branches once; under "bq" a warp takes its
// candidate's extrema once, in its first query's sweep.
#include "env_scan.cuh"
#include "kim.cuh"
#include "lb_routines.cuh"

namespace repro {

// Dynamic shared memory of one warp: its H row, its staged candidate row
// ("bq") and its pass-2 envelope buffer.
__host__ __device__ __forceinline__ size_t fused_warp_elems(int n, int w, bool bq) {
  return (size_t)n * (bq ? 2 : 1) + 4 * (size_t)(n + 2 * w);
}

// Whether a launch takes the long-row path: one warp's buffers overflow
// a block's shared memory (kernels/lb_fused/ops.py fused_long repeats it).
template <typename T> __host__ __device__ __forceinline__ bool fused_long(int n, int w, bool bq) {
  return sizeof(T) * fused_warp_elems(n, w, bq) > SMEM_LIMIT;
}

// One warp's pairs.  LONG: each warp's H row and pass-2 buffers are a
// slice of the workspace ws (EnvLayout's one-row buffers, the H row
// written into its staged row's place and padded there), pass 2 is K3's
// (improved_terms over the envelope_join scans), and "bq" reads its
// candidate row in place.  KIM: the kim entry (qfeat, the queries'
// features); the kernel picks the body by whether qfeat is given.  The
// two bodies run the same pass 1 and pass 2 instructions; of the layouts
// measured in the host driver's loop (tools/ab_k4_in_loop.py) this one
// ran K4 fastest with and without the entry.
template <typename T, int P, bool BQ, bool LONG, bool KIM>
__device__ __forceinline__ void lb_fused_warp(
    const T* __restrict__ cands, const T* __restrict__ qs, const T* __restrict__ upper,
    const T* __restrict__ lower, const T* __restrict__ bounds, int64_t bound_stride,
    const T* __restrict__ qfeat, int64_t nq, int64_t nb, int n, int w, int tile_b,
    int64_t real, T* __restrict__ lb1_out, T* __restrict__ lb_out,
    uint8_t* __restrict__ stage_out, T* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const EnvLayout<T> g(n, w);
  T* hs;
  T* buf;  // the short path's envelope buffer, or the long path's U row
  if constexpr (LONG) {
    T* X = ws + ((size_t)blockIdx.x * tile_b + warp) * g.per_warp(1);
    hs = X + w;
    buf = X + g.xlen;
  } else {
    hs = reinterpret_cast<T*>(smem_raw) + (size_t)warp * fused_warp_elems(n, w, BQ);
    buf = hs + (size_t)n * (BQ ? 2 : 1);
  }
  const int64_t ntiles = (nb + tile_b - 1) / tile_b;
  const int64_t t = BQ ? blockIdx.x : blockIdx.x % ntiles;
  const int64_t c = t * tile_b + warp;
  if (c >= nb) return;  // no block barrier follows: a warp may leave
  const T* cr = cands + c * n;
  T cfirst = T(0), clast = T(0), cmax = T(0), cmin = T(0);  // the kim entry's
  if constexpr (KIM) {
    cfirst = cr[0];
    clast = cr[n - 1];
  }
  if (BQ && !LONG) {
    T* row = hs + n;
    for (int i = lane; i < n; i += 32) row[i] = cr[i];
    __syncwarp();
    cr = row;
  }
  const int64_t q_begin = BQ ? 0 : blockIdx.x / ntiles;
  const int64_t q_end = BQ ? nq : q_begin + 1;
  for (int64_t q = q_begin; q < q_end; ++q) {
    const T* uq = upper + q * n;
    const T* lq = lower + q * n;
    // the first query's sweep takes the candidate's extrema; the body
    // without the kim entry never reads them, so its sweep is pass 1 alone
    const T lb1 = q == q_begin
                      ? keogh_pair<T, P, true>(cr, uq, lq, hs, n, lane, &cmax, &cmin)
                      : keogh_pair<T, P>(cr, uq, lq, hs, n, lane);
    __syncwarp();  // H complete before any lane reads it
    const T bound = bounds[q * bound_stride];
    // LB_Kim >= bound prunes first; the same in every lane
    const bool kim_dead =
        KIM && !(kim_bound<T, P>(cfirst, clast, cmax, cmin, qfeat + 4 * q) < bound);
    T lb = lb1;
    if (!kim_dead && lb1 < bound) {  // the same in every lane: the warp stays converged
      if constexpr (LONG) {
        T* X = hs - w;
        T r;
        if (w == 0) {
          r = improved_terms<T, P>(hs, hs, qs + q * n, n, lane);
        } else {
          T* lbuf = buf + g.olen;
          pad_row(X, g, lane);
          envelope_join<T, true>(X, g, buf, lbuf + g.olen, lane);
          envelope_join<T, false>(X, g, lbuf, lbuf + g.olen, lane);
          r = improved_terms<T, P>(buf, lbuf, qs + q * n, n, lane);
        }
        lb = lb1 + r;
      } else {
        lb = lb1 + improved_pair<T, P>(hs, qs + q * n, n, w, buf, lane);
      }
    }
    if (lane == 0) {
      lb1_out[q * nb + c] = lb1;
      lb_out[q * nb + c] = lb;
      if (stage_out)
        stage_out[q * nb + c] =
            c >= real ? 255
            : kim_dead ? 0
                       : (KIM ? 1 : 0) + (lb1 < bound ? (lb < bound ? 2 : 1) : 0);
    }
    __syncwarp();  // H and the envelope buffer are rewritten for the next query
  }
}

template <typename T, int P, bool BQ, bool LONG>
__global__ void __launch_bounds__(1024)
lb_fused_kernel(const T* __restrict__ cands, const T* __restrict__ qs,
                const T* __restrict__ upper, const T* __restrict__ lower,
                const T* __restrict__ bounds, int64_t bound_stride,
                const T* __restrict__ qfeat, int64_t nq, int64_t nb, int n, int w,
                int tile_b, int64_t real, T* __restrict__ lb1_out, T* __restrict__ lb_out,
                uint8_t* __restrict__ stage_out, T* __restrict__ ws) {
  if (qfeat)  // the same in every thread
    lb_fused_warp<T, P, BQ, LONG, true>(cands, qs, upper, lower, bounds, bound_stride, qfeat,
                                        nq, nb, n, w, tile_b, real, lb1_out, lb_out,
                                        stage_out, ws);
  else
    lb_fused_warp<T, P, BQ, LONG, false>(cands, qs, upper, lower, bounds, bound_stride,
                                         qfeat, nq, nb, n, w, tile_b, real, lb1_out, lb_out,
                                         stage_out, ws);
}

template <typename T, int P, bool BQ, bool LONG>
cudaError_t launch_lb_fused_path(const T* cands, const T* qs, const T* upper,
                            const T* lower, const T* bounds, int64_t bound_stride,
                            const T* qfeat, int64_t nq, int64_t nb, int n, int w, int tile_b,
                            int64_t real, T* lb1, T* lb, uint8_t* stage, T* ws,
                            cudaStream_t s) {
  if (tile_b < 1 || tile_b > 32) return cudaErrorInvalidValue;
  const int64_t ntiles = (nb + tile_b - 1) / tile_b;
  size_t smem = 0;
  if (LONG) {
    if (ws == nullptr) return cudaErrorInvalidValue;
  } else {
    smem = sizeof(T) * tile_b * fused_warp_elems(n, w, BQ);
    cudaError_t err = allow_smem(lb_fused_kernel<T, P, BQ, LONG>, smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)(BQ ? ntiles : ntiles * nq);
  lb_fused_kernel<T, P, BQ, LONG><<<blocks, 32 * tile_b, smem, s>>>(
      cands, qs, upper, lower, bounds, bound_stride, qfeat, nq, nb, n, w, tile_b, real,
      lb1, lb, stage, ws);
  return cudaGetLastError();
}

template <typename T, int P, bool BQ>
cudaError_t launch_lb_fused(const T* cands, const T* qs, const T* upper,
                            const T* lower, const T* bounds, int64_t bound_stride,
                            const T* qfeat, int64_t nq, int64_t nb, int n, int w, int tile_b,
                            int64_t real, T* lb1, T* lb, uint8_t* stage, T* ws,
                            cudaStream_t s) {
  if (fused_long<T>(n, w, BQ))
    return launch_lb_fused_path<T, P, BQ, true>(cands, qs, upper, lower, bounds,
                                                bound_stride, qfeat, nq, nb, n, w, tile_b, real, lb1, lb, stage, ws, s);
  return launch_lb_fused_path<T, P, BQ, false>(cands, qs, upper, lower, bounds,
                                               bound_stride, qfeat, nq, nb, n, w, tile_b, real, lb1, lb, stage, ws, s);
}

// Bytes of workspace of a launch: one warp's buffers per warp of the grid
// on the long-row path, else 0.
template <typename T>
size_t lb_fused_workspace(int64_t nq, int64_t nb, int n, int w, int tile_b, bool bq) {
  if (!fused_long<T>(n, w, bq) || tile_b < 1 || nq * nb == 0) return 0;
  const int64_t ntiles = (nb + tile_b - 1) / tile_b;
  const int64_t blocks = bq ? ntiles : ntiles * nq;
  return sizeof(T) * (size_t)blocks * tile_b * EnvLayout<T>(n, w).per_warp(1);
}

}  // namespace repro

// cands (B, n); qs, upper, lower (Q, n); bounds[q * bound_stride] the
// bound of query q; qfeat (Q, 4) the queries' LB_Kim features (first,
// last, max, min) for the kim entry, or nullptr; lb1, lb (Q, B); stage
// (Q, B) uint8 or nullptr; 0 <= w <= n - 1; tile_b warps per block,
// 1..32; grid_bq 0 for "qb", 1 for "bq"; p in {1, 2}; candidates c >= real
// get stage 255.
extern "C" int repro_lb_fused(int dtype, int pcode, const void* cands,
                              const void* qs, const void* upper,
                              const void* lower, const void* bounds,
                              int64_t bound_stride, const void* qfeat, int64_t nq,
                              int64_t nb, int n,
                              int w, int tile_b, int grid_bq, int64_t real,
                              void* lb1, void* lb, void* stage, void* workspace,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq * nb == 0) return (int)cudaGetLastError();
  if (pcode != 1 && pcode != 2) return (int)cudaErrorInvalidValue;
  uint8_t* st = static_cast<uint8_t*>(stage);
  REPRO_DISPATCH(dtype, pcode,
    if (grid_bq)
      return (int)repro::launch_lb_fused<T, P, true>(
          static_cast<const T*>(cands), static_cast<const T*>(qs),
          static_cast<const T*>(upper), static_cast<const T*>(lower),
          static_cast<const T*>(bounds), bound_stride, static_cast<const T*>(qfeat), nq,
          nb, n, w, tile_b, real,
          static_cast<T*>(lb1), static_cast<T*>(lb), st, static_cast<T*>(workspace), s);
    return (int)repro::launch_lb_fused<T, P, false>(
        static_cast<const T*>(cands), static_cast<const T*>(qs),
        static_cast<const T*>(upper), static_cast<const T*>(lower),
        static_cast<const T*>(bounds), bound_stride, static_cast<const T*>(qfeat), nq,
          nb, n, w, tile_b, real,
        static_cast<T*>(lb1), static_cast<T*>(lb), st, static_cast<T*>(workspace), s));
  return (int)cudaGetLastError();
}

// Bytes of workspace repro_lb_fused needs at this shape (0: none).
extern "C" int64_t repro_lb_fused_workspace(int dtype, int64_t nq, int64_t nb, int n, int w,
                                            int tile_b, int grid_bq) {
  return (int64_t)(dtype == 0 ? repro::lb_fused_workspace<float>(nq, nb, n, w, tile_b, grid_bq)
                              : repro::lb_fused_workspace<double>(nq, nb, n, w, tile_b, grid_bq));
}
