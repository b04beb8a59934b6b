// K4: both passes of LB_Improved on one resident candidate tile, pass 2
// predicated on the pruning bound (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/lb_fused/kernel.py:
// lb_fused_qbatch_pallas (_fused_tile_compute; bodies _lb_fused_kernel,
// _lb_fused_db_qb_kernel and _lb_fused_db_bq_kernel).
//
// For each (query q, candidate c) pair, with bound[q] the query's powered
// pruning bound:
//   lb1 = LB_Keogh (pass 1), H = clip(c, L_q, U_q),
//   lb  = lb1 + lb2(H, q) where lb1 < bound[q], else lb1,
// for p in {1, 2}.  H never leaves shared memory; two values per pair are
// written.  A tile with no live lane runs pass 1 only.
//
// Bound on this card: bytes (each candidate row read once, two values per
// pair written); at the host driver's shapes the launch itself dominates.
// Design: one 256-thread block per (query, tile of tile_b candidates)
// (grid "qb"), or one block per tile looping over the queries with the
// tile staged in shared memory once (grid "bq").  Pass 1 runs one warp per
// pair (lb_routines.cuh: keogh_pair, as K2 does) and keeps H in shared
// memory; then each live pair runs pass 2 on the whole block
// (improved_row, as K3 does).  Both routines are K2's and K3's own, so lb1
// is bit-equal to K2's lb and lb to K2's lb plus K3's lb2.  A ragged last
// tile is masked, never padded: no pad lane can keep pass 2 alive.
#include "lb_routines.cuh"

namespace repro {

constexpr int FUSED_WARPS = PASS2_THREADS / 32;

// Dynamic shared memory: H rows, the staged tile ("bq"), the pass-2
// envelope buffer and the tile's lb1 values.
__host__ __device__ __forceinline__ size_t fused_smem_elems(int n, int w,
                                                           int tile_b, bool bq) {
  return (size_t)tile_b * n * (bq ? 2 : 1) + 4 * (size_t)(n + 2 * w) + tile_b;
}

template <typename T, int P, bool BQ>
__global__ void __launch_bounds__(PASS2_THREADS)
lb_fused_kernel(const T* __restrict__ cands, const T* __restrict__ qs,
                const T* __restrict__ upper, const T* __restrict__ lower,
                const T* __restrict__ bounds, int64_t nq, int64_t nb, int n,
                int w, int tile_b, T* __restrict__ lb1_out,
                T* __restrict__ lb_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T scratch[32];
  T* hs = reinterpret_cast<T*>(smem_raw);
  T* tile = hs + (size_t)tile_b * n;  // "bq" only
  T* buf = tile + (BQ ? (size_t)tile_b * n : 0);
  T* lb1s = buf + 4 * (size_t)(n + 2 * w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t ntiles = (nb + tile_b - 1) / tile_b;
  const int64_t t = BQ ? blockIdx.x : blockIdx.x % ntiles;
  const int64_t c0 = t * tile_b;
  const int rows = nb - c0 < tile_b ? (int)(nb - c0) : tile_b;
  if (BQ) {
    for (int64_t i = threadIdx.x; i < (int64_t)rows * n; i += blockDim.x)
      tile[i] = cands[c0 * n + i];
    __syncthreads();
  }
  const int64_t q_begin = BQ ? 0 : blockIdx.x / ntiles;
  const int64_t q_end = BQ ? nq : q_begin + 1;
  for (int64_t q = q_begin; q < q_end; ++q) {
    const T* ur = upper + q * n;
    const T* lr = lower + q * n;
    for (int j = warp; j < rows; j += FUSED_WARPS) {
      const T* cr = BQ ? tile + (size_t)j * n : cands + (c0 + j) * n;
      const T acc = keogh_pair<T, P>(cr, ur, lr, hs + (size_t)j * n, n, lane);
      if (lane == 0) lb1s[j] = acc;
    }
    __syncthreads();
    const T bound = bounds[q];
    for (int j = 0; j < rows; ++j) {
      const T lb1 = lb1s[j];
      T lb = lb1;
      if (lb1 < bound)  // the same for every thread: the block stays converged
        lb = lb1 + improved_row<T, P>(hs + (size_t)j * n, qs + q * n, n, w,
                                      buf, scratch);
      if (threadIdx.x == 0) {
        lb1_out[q * nb + c0 + j] = lb1;
        lb_out[q * nb + c0 + j] = lb;
      }
    }
    __syncthreads();  // H and lb1s are rewritten for the next query
  }
}

template <typename T, int P, bool BQ>
cudaError_t launch_lb_fused(const T* cands, const T* qs, const T* upper,
                            const T* lower, const T* bounds, int64_t nq,
                            int64_t nb, int n, int w, int tile_b, T* lb1,
                            T* lb, cudaStream_t s) {
  if (tile_b < 1) return cudaErrorInvalidValue;
  const int64_t ntiles = (nb + tile_b - 1) / tile_b;
  const size_t smem = sizeof(T) * fused_smem_elems(n, w, tile_b, BQ);
  cudaError_t err = allow_smem(lb_fused_kernel<T, P, BQ>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(BQ ? ntiles : ntiles * nq);
  lb_fused_kernel<T, P, BQ><<<blocks, PASS2_THREADS, smem, s>>>(
      cands, qs, upper, lower, bounds, nq, nb, n, w, tile_b, lb1, lb);
  return cudaGetLastError();
}

}  // namespace repro

// cands (B, n); qs, upper, lower (Q, n); bounds (Q,); lb1, lb (Q, B);
// 0 <= w <= n - 1; grid_bq 0 for "qb", 1 for "bq"; p in {1, 2}.
extern "C" int repro_lb_fused(int dtype, int pcode, const void* cands,
                              const void* qs, const void* upper,
                              const void* lower, const void* bounds, int64_t nq,
                              int64_t nb, int n, int w, int tile_b, int grid_bq,
                              void* lb1, void* lb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq * nb == 0) return (int)cudaGetLastError();
  if (pcode != 1 && pcode != 2) return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, pcode,
    if (grid_bq)
      return (int)repro::launch_lb_fused<T, P, true>(
          static_cast<const T*>(cands), static_cast<const T*>(qs),
          static_cast<const T*>(upper), static_cast<const T*>(lower),
          static_cast<const T*>(bounds), nq, nb, n, w, tile_b,
          static_cast<T*>(lb1), static_cast<T*>(lb), s);
    return (int)repro::launch_lb_fused<T, P, false>(
        static_cast<const T*>(cands), static_cast<const T*>(qs),
        static_cast<const T*>(upper), static_cast<const T*>(lower),
        static_cast<const T*>(bounds), nq, nb, n, w, tile_b,
        static_cast<T*>(lb1), static_cast<T*>(lb), s));
  return (int)cudaGetLastError();
}
