// K5: banded DTW_p with a per-lane abandon bound (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/dtw/kernel.py: dtw_banded_pallas
// (_dtw_lane, _dtw_kernel, _dtw_db_kernel).
//
// For each (query, candidate) pair the band DP of half-width w runs row
// by row; row i holds the 2w+1 cells of columns j = i + k - w.  Cells are
//   D[i,j] = cost(q_i - c_j) + min(D[i-1,j], D[i,j-1], D[i-1,j-1])   (p = 1, 2)
//   D[i,j] = max(|q_i - c_j|, min(...))                             (p = inf)
// with powered costs.  Abandon rule, as in the reference: before each row
// the lane stops if min(previous row) >= bound; a lane that ran all n rows
// returns D[n-1, n-1], an abandoned one returns that row minimum
// (>= bound).  A bound of BIG gives the full DP.  Cells outside 0 <= j < n
// are skipped (held at BIG), not padded with PAD_VALUE.
//
// Bound on this card: operations, and in practice the latency of the
// row-to-row dependency; the inputs are two rows of n values per pair.
// Design: one warp per pair.  The query row, the candidate row and two
// band rows live in shared memory.  Within a row the left-to-right
// recurrence x_k = f_k(x_{k-1}) is a composition of functions
// f(x) = min(a, b + x) (finite p) or f(x) = min(hi, max(lo, x)) (p = inf),
// both closed under composition; each lane composes its contiguous
// segment, a 5-step shuffle scan composes across lanes, and each lane then
// replays its segment from the incoming value.  Replay uses the textbook
// cell arithmetic; at p = inf all of it is exact (max/min only).
#include "common.cuh"

namespace repro {

// x -> min(a, b + x) for finite p; x -> min(b, max(a, x)) for p = inf.
template <typename T, int P> __device__ __forceinline__ T fn_apply(T a, T b, T x) {
  return P == 0 ? tmin(b, tmax(a, x)) : tmin(a, b + x);
}

// (a, b) <- later o earlier.
template <typename T, int P>
__device__ __forceinline__ void fn_compose(T a2, T b2, T a1, T b1, T& a, T& b) {
  if (P == 0) {
    a = tmin(b2, tmax(a2, a1));
    b = tmin(b2, tmax(a2, b1));
  } else {
    a = tmin(a2, b2 + a1);
    b = b2 + b1;
  }
}

template <typename T, int P> __device__ __forceinline__ T fn_id_a() {
  return P == 0 ? -big<T>() : big<T>();
}
template <typename T, int P> __device__ __forceinline__ T fn_id_b() {
  return P == 0 ? big<T>() : T(0);
}

template <typename T, int P>
__global__ void dtw_kernel(const T* __restrict__ qs, const T* __restrict__ cands,
                           const int64_t* __restrict__ qidx,
                           const int64_t* __restrict__ cidx,
                           const T* __restrict__ bounds, int64_t bstride, int n,
                           int w, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int width = 2 * w + 1;
  T* prev = reinterpret_cast<T*>(smem_raw);  // width + 1 (last = BIG)
  T* cur = prev + (width + 1);
  T* qrow = cur + (width + 1);
  T* crow = qrow + n;
  const int lane = threadIdx.x;
  const int64_t pair = blockIdx.x;
  const int64_t q = qidx ? qidx[pair] : pair / bstride;
  const int64_t c = cidx ? cidx[pair] : pair % bstride;
  const T bound = bounds ? bounds[pair] : big<T>();
  for (int k = lane; k < n; k += 32) {
    qrow[k] = qs[q * n + k];
    crow[k] = cands[c * n + k];
  }
  for (int k = lane; k <= width; k += 32) {
    prev[k] = k == w ? T(0) : big<T>();
    cur[k] = big<T>();
  }
  __syncwarp();
  const int seg = (width + 31) / 32;
  const int k0 = min(lane * seg, width), k1 = min(k0 + seg, width);
  int i = 0;
  T m = T(0);  // min of the previous row; the origin row's is 0
  while (i < n && m < bound) {
    const T qi = qrow[i];
    // pass 1: compose this lane's segment of cell functions
    T a = fn_id_a<T, P>(), b = fn_id_b<T, P>();
    for (int k = k0; k < k1; ++k) {
      const int j = i + k - w;
      T ca = big<T>(), cb = big<T>();
      if (j >= 0 && j < n) {
        const T d = cost_of<T, P>(qi > crow[j] ? qi - crow[j] : crow[j] - qi);
        const T bk = tmin(prev[k], prev[k + 1]);
        ca = P == 0 ? d : d + bk;
        cb = P == 0 ? tmax(bk, d) : d;
      }
      fn_compose<T, P>(ca, cb, a, b, a, b);
    }
    // inclusive scan across lanes, then shift to exclusive
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T ua = __shfl_up_sync(0xffffffffu, a, off);
      const T ub = __shfl_up_sync(0xffffffffu, b, off);
      if (lane >= off) fn_compose<T, P>(a, b, ua, ub, a, b);
    }
    T ea = __shfl_up_sync(0xffffffffu, a, 1);
    T eb = __shfl_up_sync(0xffffffffu, b, 1);
    if (lane == 0) {
      ea = fn_id_a<T, P>();
      eb = fn_id_b<T, P>();
    }
    // pass 2: replay the segment from the value left of it
    T x = tmin(fn_apply<T, P>(ea, eb, big<T>()), big<T>());
    T lmin = big<T>();
    for (int k = k0; k < k1; ++k) {
      const int j = i + k - w;
      if (j >= 0 && j < n) {
        const T d = cost_of<T, P>(qi > crow[j] ? qi - crow[j] : crow[j] - qi);
        const T bk = tmin(prev[k], prev[k + 1]);
        x = P == 0 ? tmax(d, tmin(bk, x)) : d + tmin(bk, x);
        x = tmin(x, big<T>());
      } else {
        x = big<T>();
      }
      cur[k] = x;
      lmin = tmin(lmin, x);
    }
    m = warp_min(lmin);
    __syncwarp();
    T* t = prev; prev = cur; cur = t;
    ++i;
  }
  if (lane == 0) out[pair] = i == n ? prev[w] : m;
}

}  // namespace repro

// qs (Q, n); cands (Nc, n); bounds (npairs,) powered, or nullptr for BIG;
// out (npairs,) powered.  Dense mode: qidx = cidx = nullptr and
// npairs = Q * bstride.  0 <= w <= n - 1.
extern "C" int repro_dtw(int dtype, int pcode, const void* qs, const void* cands,
                         const int64_t* qidx, const int64_t* cidx,
                         const void* bounds, int64_t npairs, int64_t bstride,
                         int n, int w, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 0) return (int)cudaGetLastError();
  REPRO_DISPATCH(dtype, pcode,
    const size_t smem = sizeof(T) * (2 * (size_t)(2 * w + 2) + 2 * (size_t)n);
    cudaError_t err = repro::allow_smem(repro::dtw_kernel<T, P>, smem);
    if (err != cudaSuccess) return (int)err;
    repro::dtw_kernel<T, P><<<(unsigned)npairs, 32, smem, s>>>(
        static_cast<const T*>(qs), static_cast<const T*>(cands), qidx, cidx,
        static_cast<const T*>(bounds), bstride, n, w, static_cast<T*>(out)));
  return (int)cudaGetLastError();
}
