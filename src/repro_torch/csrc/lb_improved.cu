// K3: LB_Improved pass 2 over projections H (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/lb_improved/kernel.py:
// lb_improved_pass2_qbatch_pallas (_lb2_qbatch_kernel), and its
// single-query form lb_improved_pass2_pallas (_lb2_kernel) as Q = 1.
//
// For each projection row H (one per (query, candidate) pair) with query
// row q = qs[qidx]:
//   U(H), L(H)  = the band-w envelope of H (as K1 computes it), and
//   lb2         = sum_i dist(q_i, [L(H)_i, U(H)_i])^p (the max at p = inf).
// The stage adds lb2 to LB_Keogh (the max of the two at p = inf).
//
// Bound on this card: bytes.  Each H row is read once and one value per
// row is written; the envelope costs about log2(2w+1) comparisons per
// value and side.
// Design: one block per H row (lb_routines.cuh: improved_row).  The row
// is staged in shared memory, padded there with +-inf (no padded copy of
// H in device memory, unlike the reference op's sentinel-padded inputs),
// enveloped by doubling (common.cuh: sliding_extrema) and reduced across
// the block.  Rows are the dense (Q, B) stack (qidx == nullptr: q = row / B)
// or an explicit per-row query index, so one entry serves the dense stage
// and the compacted per-pair stage.
#include "lb_routines.cuh"

namespace repro {

template <typename T, int P>
__global__ void lb_improved_pass2_kernel(const T* __restrict__ h,
                                         const T* __restrict__ qs,
                                         const int64_t* __restrict__ qidx,
                                         int64_t bstride, int n, int w,
                                         T* __restrict__ lb2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  __shared__ T scratch[32];
  const int64_t row = blockIdx.x;
  const int64_t q = qidx ? qidx[row] : row / bstride;
  const T acc = improved_row<T, P>(h + row * n, qs + q * n, n, w, buf, scratch);
  if (threadIdx.x == 0) lb2[row] = acc;
}

}  // namespace repro

// h (rows, n); qs (Q, n); lb2 (rows,); 1 <= w <= n - 1.
// Dense mode: qidx = nullptr and rows = Q * bstride.
extern "C" int repro_lb_improved_pass2(int dtype, int pcode, const void* h,
                                       const void* qs, const int64_t* qidx,
                                       int64_t rows, int64_t bstride, int n,
                                       int w, void* lb2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return (int)cudaGetLastError();
  REPRO_DISPATCH(dtype, pcode,
    const size_t smem = sizeof(T) * 4 * (size_t)(n + 2 * w);
    cudaError_t err = repro::allow_smem(repro::lb_improved_pass2_kernel<T, P>, smem);
    if (err != cudaSuccess) return (int)err;
    repro::lb_improved_pass2_kernel<T, P><<<(unsigned)rows, repro::PASS2_THREADS, smem, s>>>(
        static_cast<const T*>(h), static_cast<const T*>(qs), qidx, bstride, n,
        w, static_cast<T*>(lb2)));
  return (int)cudaGetLastError();
}
