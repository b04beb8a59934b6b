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
// row is written; the envelope costs a few comparisons per value and
// side.
// Design: one warp per row, up to ENV_MAX_WARPS warps per block and just
// enough blocks to fill the card once (env_scan.cuh, K1's warp per row).
// Each warp loops over rows and copies its next H row into shared memory
// with 16-byte cp.async while it reduces the current one, padded there
// with its edge values; the envelope is built by chunked van
// Herk-Gil-Werman scans, each side joined in place (U, then L, n values
// each), with warp barriers only; then lane l adds the terms of elements
// l, l + 32, ... into accumulator (i / 32) % 8 (lb_routines.cuh:
// improved_terms), the sum order of a block of PASS2_THREADS threads per
// row; K4's pass 2 adds the same terms in the same order, so K4 is
// bit-equal to K2 + K3.  A warp's buffers are its staged rows (n + 2w
// values each) plus 2n values for U and L.  Where one staged row and U
// and L do not fit in shared memory, the same scans
// run on buffers in a workspace in device memory (one slice per warp,
// ENV_LONG_BLOCKS blocks at most), so any n whose tensors fit runs.
// Rows are the dense (Q, B) stack (qidx == nullptr: q = row / B) or an
// explicit per-row query index, so one entry serves the dense stage and
// the compacted per-pair stage.
#include "env_scan.cuh"
#include "lb_routines.cuh"

namespace repro {

template <typename T, int P, bool LONG>
__global__ void __launch_bounds__(32 * ENV_MAX_WARPS)
lb_improved_pass2_kernel(const T* __restrict__ h, const T* __restrict__ qs,
                         const int64_t* __restrict__ qidx, int64_t rows, int64_t bstride,
                         int n, int w, int nbuf, T* __restrict__ lb2, T* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const EnvLayout<T> g(n, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* base;
  if constexpr (LONG)
    base = ws + ((size_t)blockIdx.x * (blockDim.x >> 5) + warp) * g.per_warp(1);
  else
    base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * g.per_warp(nbuf);
  T* ub = base + (size_t)nbuf * g.xlen;
  T* lbuf = ub + g.olen;
  T* cm = lbuf + g.olen;
  warp_rows<T, LONG>(h, rows, g, nbuf, base, [&](int64_t row, const T* X) {
    const int64_t q = qidx ? qidx[row] : row / bstride;
    T acc;
    if (w == 0) {  // the envelope of H is H
      acc = improved_terms<T, P>(X, X, qs + q * n, n, lane);
    } else {
      envelope_join<T, true>(X, g, ub, cm, lane);
      envelope_join<T, false>(X, g, lbuf, cm, lane);
      acc = improved_terms<T, P>(ub, lbuf, qs + q * n, n, lane);
    }
    if (lane == 0) lb2[row] = acc;
    __syncwarp();  // U and L are rewritten for the next row
  });
}

template <typename T, int P>
cudaError_t pass2_launch(const T* h, const T* qs, const int64_t* qidx, int64_t rows,
                         int64_t bstride, int n, int w, T* lb2, T* ws, cudaStream_t s) {
  if (w < 0 || w > n - 1) return cudaErrorInvalidValue;
  const int nbuf = env_nbuf<T>(n, w);
  if (nbuf == 0) {  // the long-row path: buffers in the workspace
    if (ws == nullptr) return cudaErrorInvalidValue;
    lb_improved_pass2_kernel<T, P, true>
        <<<(unsigned)env_long_blocks(rows), 32 * ENV_MAX_WARPS, 0, s>>>(
            h, qs, qidx, rows, bstride, n, w, 1, lb2, ws);
    return cudaGetLastError();
  }
  int warps = 1;
  unsigned blocks = 0;
  const size_t warp_bytes = sizeof(T) * EnvLayout<T>(n, w).per_warp(nbuf);
  cudaError_t err = env_grid(lb_improved_pass2_kernel<T, P, false>, warp_bytes, rows, warps,
                             blocks);
  if (err != cudaSuccess) return err;
  lb_improved_pass2_kernel<T, P, false><<<blocks, 32 * warps, warps * warp_bytes, s>>>(
      h, qs, qidx, rows, bstride, n, w, nbuf, lb2, nullptr);
  return cudaGetLastError();
}

}  // namespace repro

// h (rows, n); qs (Q, n); lb2 (rows,); 0 <= w <= n - 1.
// Dense mode: qidx = nullptr and rows = Q * bstride.  `workspace` holds
// repro_lb_improved_pass2_workspace bytes where a warp's buffers do not
// fit in shared memory (else it is unused and may be null).
extern "C" int repro_lb_improved_pass2(int dtype, int pcode, const void* h,
                                       const void* qs, const int64_t* qidx,
                                       int64_t rows, int64_t bstride, int n,
                                       int w, void* lb2, void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return (int)cudaGetLastError();
  REPRO_DISPATCH(dtype, pcode,
    return (int)repro::pass2_launch<T, P>(
        static_cast<const T*>(h), static_cast<const T*>(qs), qidx, rows, bstride, n, w,
        static_cast<T*>(lb2), static_cast<T*>(workspace), s));
  return (int)cudaGetLastError();
}

// Bytes of workspace repro_lb_improved_pass2 needs at this shape (0: none).
extern "C" int64_t repro_lb_improved_pass2_workspace(int dtype, int64_t rows, int n, int w) {
  return (int64_t)(dtype == 0 ? repro::env_workspace_bytes<float>(rows, n, w)
                              : repro::env_workspace_bytes<double>(rows, n, w));
}
