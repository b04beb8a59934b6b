// K1: warping envelope U, L of a batch of rows (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/envelope/kernel.py:
// envelope_pallas_padded (_envelope_kernel), van Herk-Gil-Werman on
// +-BIG-padded rows.
//
// Bound on this card: bytes.  A row of n values is read once and U and L
// (2n values) are written once; the sliding extrema need a few
// comparisons per value and side, far below the H100's arithmetic rate.
// The launch picks the warps per row from the batch: a small batch
// (up to ENV_SMALL_ROWS rows) cannot fill the card, so its time is one
// row's chain, and it runs a block of 8 warps per row that reduces the
// row by doubling (common.cuh: sliding_extrema, about log2(2w + 1)
// steps).  A larger batch is bound by bytes and runs one warp per row:
// one warp per row, up to ENV_MAX_WARPS warps per block and just
// enough blocks to fill the card once; each warp loops over rows and
// copies its next row into shared memory (cp.async, 16 bytes per lane
// where the row allows it) while it works on the current one, so the
// card always has loads in flight.  The row is padded in shared memory
// with w copies of its first and last value: every window that reaches a
// pad holds that edge value already, so the pads change no extreme.  The
// padded row (lp = n + 2w values) is cut into chunks of C values, C odd
// (32 lanes at a stride of C hit 32 banks) and at most 2w - 1 (so every
// window spans two chunks); lane c takes chunks c, c + 32, ...  Per side
// (max for U, min for L) one backward pass per chunk writes the suffix
// extremes S and the chunk's extreme, and one forward pass writes the
// prefix extremes joined with the whole chunks that lie between the
// window's ends; the extreme over the window [i, i + 2w] of the padded
// row is then ext(S[i], P[i]), written with 16-byte streaming stores.  Shared
// memory sees about six accesses per value of the row and side, and each
// lane's chain is two scans of its chunks (env_scan.cuh).  Max and min
// are exact, so U and L are bit-equal to the plain PyTorch version.
// Long rows, whose one staged row and S, P buffers overflow a block's
// shared memory, run the same scans with the buffers in a workspace in
// device memory (one slice per warp, ENV_LONG_BLOCKS blocks at most), the
// row copied there by plain loads: any n whose tensors fit runs.
#include "env_scan.cuh"

namespace repro {

// Batches of up to this many rows run a block per row: on an H100 it is
// the faster of the two up to a few hundred rows of 1,000 values, and
// further for shorter rows (tools/ab_envelope.py, PERF.md).
constexpr int64_t ENV_SMALL_ROWS = 256;
// Threads of the block per row.
constexpr int ENV_ROW_THREADS = 256;

// A small batch: block `row` reduces its row by doubling in shared
// memory (4 (n + 2w) values, the row padded there with -+inf).  No
// __launch_bounds__: with one (256) it ran 7% slower at 16 to 256 rows.
template <typename T>
__global__ void envelope_rows_kernel(const T* __restrict__ x, T* __restrict__ u,
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

// Rows row0, row0 + stride, ... one warp each (env_scan.cuh warp_rows):
// nbuf = 2 copies the next row while the current one is worked on,
// nbuf = 1 copies each row when its turn comes (rows whose two buffers
// would not fit); LONG keeps the warp's buffers in the workspace ws.
template <typename T, bool LONG>
__global__ void __launch_bounds__(32 * ENV_MAX_WARPS)
envelope_kernel(const T* __restrict__ x, T* __restrict__ u, T* __restrict__ l,
                int64_t rows, int n, int w, int nbuf, T* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = 16 / sizeof(T);
  const EnvLayout<T> g(n, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* base;
  if constexpr (LONG)
    base = ws + ((size_t)blockIdx.x * (blockDim.x >> 5) + warp) * g.per_warp(1);
  else
    base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * g.per_warp(nbuf);
  T* sbuf = base + (size_t)nbuf * g.xlen;
  T* pbuf = sbuf + g.olen;
  T* cm = pbuf + g.olen;
  // 16-byte stores where U's and L's rows share their alignment
  const bool vec = ((reinterpret_cast<uintptr_t>(u) ^ reinterpret_cast<uintptr_t>(l)) & 15) == 0;
  warp_rows<T, LONG>(x, rows, g, nbuf, base, [&](int64_t row, const T* X) {
    T* ur = u + row * n;
    const int osh = vec ? (V - head_elems(ur) % V) % V : 0;
    envelope_side<T, true>(X, g, sbuf + osh, pbuf + osh, cm, ur, vec, lane);
    envelope_side<T, false>(X, g, sbuf + osh, pbuf + osh, cm, l + row * n, vec, lane);
  });
}

template <typename T>
int envelope_launch(const void* x, void* u, void* l, int64_t rows, int n, int w,
                    void* ws, cudaStream_t stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  if (w < 1 || w > n - 1) return (int)cudaErrorInvalidValue;
  const size_t row_smem = sizeof(T) * 4 * (size_t)(n + 2 * w);
  if (rows <= ENV_SMALL_ROWS && row_smem <= SMEM_LIMIT) {
    cudaError_t err = allow_smem(envelope_rows_kernel<T>, row_smem);
    if (err != cudaSuccess) return (int)err;
    envelope_rows_kernel<T><<<(unsigned)rows, ENV_ROW_THREADS, row_smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(u), static_cast<T*>(l), n, w);
    return (int)cudaGetLastError();
  }
  const int nbuf = env_nbuf<T>(n, w);
  if (nbuf == 0) {  // the long-row path: buffers in the workspace
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    envelope_kernel<T, true><<<(unsigned)env_long_blocks(rows), 32 * ENV_MAX_WARPS, 0,
                               stream>>>(
        static_cast<const T*>(x), static_cast<T*>(u), static_cast<T*>(l), rows, n, w, 1,
        static_cast<T*>(ws));
    return (int)cudaGetLastError();
  }
  int warps = 1;
  unsigned blocks = 0;
  const size_t warp_bytes = sizeof(T) * EnvLayout<T>(n, w).per_warp(nbuf);
  cudaError_t err = env_grid(envelope_kernel<T, false>, warp_bytes, rows, warps, blocks);
  if (err != cudaSuccess) return (int)err;
  envelope_kernel<T, false><<<blocks, 32 * warps, warps * warp_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(u), static_cast<T*>(l), rows, n, w, nbuf,
      nullptr);
  return (int)cudaGetLastError();
}

}  // namespace repro

// x, u, l: (rows, n) contiguous; 1 <= w <= n - 1, anything else returns
// cudaErrorInvalidValue (at w = 0, U = L = x: the wrapper's envelope_op
// returns (x, x) without a launch).  A batch of up to ENV_SMALL_ROWS rows
// whose padded row fits 4 times in a block's shared memory runs a block
// per row; any other, a warp per row, with its buffers in `workspace`
// (repro_envelope_workspace bytes, else unused and may be null) where
// they do not fit in shared memory.
extern "C" int repro_envelope(int dtype, const void* x, void* u, void* l,
                              int64_t rows, int n, int w, void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return repro::envelope_launch<float>(x, u, l, rows, n, w, workspace, s);
    case 1: return repro::envelope_launch<double>(x, u, l, rows, n, w, workspace, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bytes of workspace repro_envelope needs at this shape (0: none).
extern "C" int64_t repro_envelope_workspace(int dtype, int64_t rows, int n, int w) {
  if (rows <= repro::ENV_SMALL_ROWS &&
      (dtype == 0 ? 4 : 8) * 4 * (size_t)(n + 2 * w) <= repro::SMEM_LIMIT)
    return 0;  // a block per row
  return (int64_t)(dtype == 0 ? repro::env_workspace_bytes<float>(rows, n, w)
                              : repro::env_workspace_bytes<double>(rows, n, w));
}
