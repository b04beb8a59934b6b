// K1: warping envelope U, L of a batch of rows (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/envelope/kernel.py:
// envelope_pallas_padded (_envelope_kernel), van Herk-Gil-Werman on
// +-BIG-padded rows.
//
// Bound on this card: bytes.  A row of n values is read once and U and L
// (2n values) are written once; the sliding extrema need about log2(2w+1)
// comparisons per value and side, far below the H100's arithmetic rate.
// Design: one block per row; the row is staged in shared memory, padded
// there with +-inf (so the wrapper materialises no padded copy) and
// reduced by doubling (common.cuh: sliding_extrema).  Max and min are
// exact, so U and L are bit-equal to the plain PyTorch version.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void envelope_kernel(const T* __restrict__ x, T* __restrict__ u,
                                T* __restrict__ l, int n, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int64_t row = blockIdx.x;
  const SlidingExtrema<T> ext = sliding_extrema(x + row * n, n, w, buf);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    u[row * n + i] = ext.upper(i);
    l[row * n + i] = ext.lower(i);
  }
}

template <typename T>
int envelope_launch(const void* x, void* u, void* l, int64_t rows, int n, int w,
                    cudaStream_t stream) {
  const size_t smem = sizeof(T) * 4 * (size_t)(n + 2 * w);
  cudaError_t err = allow_smem(envelope_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0)
    envelope_kernel<T><<<(unsigned)rows, 256, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(u), static_cast<T*>(l), n, w);
  return (int)cudaGetLastError();
}

}  // namespace repro

// x, u, l: (rows, n) contiguous; 1 <= w <= n - 1 (w = 0 is handled by the
// wrapper, which returns (x, x) without a launch).
extern "C" int repro_envelope(int dtype, const void* x, void* u, void* l,
                              int64_t rows, int n, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return repro::envelope_launch<float>(x, u, l, rows, n, w, s);
    case 1: return repro::envelope_launch<double>(x, u, l, rows, n, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
