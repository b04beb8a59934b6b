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
// lane's chain is two scans of its chunks.  Max and min are exact, so U
// and L are bit-equal to the plain PyTorch version.
#include "common.cuh"

namespace repro {

// Warps per block, at most; fewer where a warp's buffers are large.
constexpr int ENV_MAX_WARPS = 4;
// Batches of up to this many rows run a block per row: on an H100 it is
// the faster of the two up to a few hundred rows of 1,000 values, and
// further for shorter rows (tools/ab_envelope.py, PERF.md).
constexpr int64_t ENV_SMALL_ROWS = 256;
// Threads of the block per row.
constexpr int ENV_ROW_THREADS = 256;
// Dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t ENV_SMEM_LIMIT = 232448;
// Values a lane loads before it runs them through a scan's chain.
constexpr int ENV_BATCH = 8;

// The chunk of a row of n values at band w >= 1: about lp / 32, odd, at
// most 2w - 1 (kernels/envelope/ops.py envelope_chunk repeats it).
__host__ __device__ inline int env_chunk(int n, int w) {
  const int c = ((n + 2 * w + 31) / 32) | 1;
  return c < 2 * w - 1 ? c : 2 * w - 1;
}

// One warp's buffers, in values: nbuf staged rows (a row of nck chunks
// plus V - 1 values of alignment shift), S and P (n values plus the
// shift), and the chunk extremes; each a whole number of 16-byte vectors.
template <typename T> struct EnvLayout {
  static constexpr int V = 16 / sizeof(T);
  int n, w, chunk, nck, xlen, olen, cmlen;
  __host__ __device__ EnvLayout(int n_, int w_) : n(n_), w(w_) {
    chunk = env_chunk(n, w);
    nck = (n + 2 * w + chunk - 1) / chunk;
    xlen = (nck * chunk + V - 1 + V - 1) / V * V;
    olen = (n + V - 1 + V - 1) / V * V;
    cmlen = (nck + V - 1) / V * V;
  }
  __host__ __device__ size_t per_warp(int nbuf) const {
    return (size_t)nbuf * xlen + 2 * (size_t)olen + cmlen;
  }
};

template <typename T> struct alignas(16) Vec16 { T v[16 / sizeof(T)]; };

// A 16-byte store marked evict-first (st.global.cs): U and L are written
// once and not read again by this kernel.
template <typename T> __device__ __forceinline__ void store_streaming(T* dst, const Vec16<T>& v) {
  if constexpr (sizeof(T) == 4)
    __stcs(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(&v));
  else
    __stcs(reinterpret_cast<double2*>(dst), *reinterpret_cast<const double2*>(&v));
}

template <typename T, bool MAX> __device__ __forceinline__ T ext(T a, T b) {
  return MAX ? tmax(a, b) : tmin(a, b);
}
template <typename T, bool MAX> __device__ __forceinline__ T ext_id() {
  return MAX ? -pos_inf<T>() : pos_inf<T>();
}

// Values before the first 16-byte aligned one, from p (at most V - 1).
template <typename T> __device__ __forceinline__ int head_elems(const T* p) {
  return (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
template <int B> __device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(B)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a row sits in its staging buffer: the padded row starts at
// buf + row_shift(src, w), so that the row's first 16-byte aligned value
// (at padded position w + head) lands on a 16-byte boundary.
template <typename T> __device__ __forceinline__ int row_shift(const T* src, int w) {
  constexpr int V = 16 / sizeof(T);
  return (V - (w + head_elems(src)) % V) % V;
}

// Start copying row src (n values) to padded positions w .. w + n - 1 of
// buf: 16-byte copies from its first aligned value on, single values
// before and after.  The caller commits the group.
template <typename T>
__device__ __forceinline__ void stage_row_async(T* buf, const T* src, int n, int w,
                                                int lane) {
  constexpr int V = 16 / sizeof(T);
  T* dst = buf + row_shift(src, w) + w;
  const int head = min(head_elems(src), n);
  for (int m = lane; m < head; m += 32) cp_async_small<sizeof(T)>(dst + m, src + m);
  const int nv = (n - head) / V;
  for (int t = lane; t < nv; t += 32) cp_async16(dst + head + t * V, src + head + t * V);
  for (int m = head + nv * V + lane; m < n; m += 32)
    cp_async_small<sizeof(T)>(dst + m, src + m);
}

// One side of the envelope of the padded row X (nck * chunk values, pads
// included) into out (n values): U for MAX, else L.  S[i] is the extreme
// of X[i .. the end of i's chunk]; P[i], b = i + 2w, that of X[the start
// of b's chunk .. b] and of every chunk strictly between i's and b's;
// out[i] = ext(S[i], P[i]) covers X[i .. i + 2w] exactly once over.
// S and P are 16-byte aligned at out's first aligned index when `vec`.
template <typename T, bool MAX>
__device__ void envelope_side(const T* __restrict__ X, const EnvLayout<T>& g,
                              T* __restrict__ S, T* __restrict__ P, T* __restrict__ cm,
                              T* __restrict__ out, bool vec, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int n = g.n, w2 = 2 * g.w, C = g.chunk, nck = g.nck, lp = n + w2;
  for (int k = lane; k < nck; k += 32) {  // suffix extremes; the chunk's own
    const int j0 = k * C;
    T s = ext_id<T, MAX>();
    int j = j0 + C - 1;
    for (; j - (ENV_BATCH - 1) >= j0; j -= ENV_BATCH) {  // loads first, then the chain
      T v[ENV_BATCH];
#pragma unroll
      for (int e = 0; e < ENV_BATCH; ++e) v[e] = X[j - e];
#pragma unroll
      for (int e = 0; e < ENV_BATCH; ++e) {
        s = ext<T, MAX>(s, v[e]);
        if (j - e < n) S[j - e] = s;
      }
    }
    for (; j >= j0; --j) {
      s = ext<T, MAX>(s, X[j]);
      if (j < n) S[j] = s;
    }
    cm[k] = s;
  }
  __syncwarp();
  for (int k = lane; k < nck; k += 32) {  // prefix extremes with the middle chunks
    const int j0 = k * C;
    const int j1 = min(j0 + C, lp);
    const int b1 = max(j0, w2);
    if (b1 >= j1) continue;  // no window ends in this chunk
    // a = b - 2w lies in chunk fa for b < cross and in fa + 1 from there
    // on; the chunks between a's and b's are fa + 1 (or fa + 2) .. k - 1
    const int fa = (b1 - w2) / C;
    const int cross = (fa + 1) * C + w2;
    T mid2 = ext_id<T, MAX>();
    for (int c = fa + 2; c < k; ++c) mid2 = ext<T, MAX>(mid2, cm[c]);
    const T mid1 = fa + 1 < k ? ext<T, MAX>(mid2, cm[fa + 1]) : mid2;
    T p = ext_id<T, MAX>();
    int j = j0;
    for (; j + ENV_BATCH <= j1; j += ENV_BATCH) {
      T v[ENV_BATCH];
#pragma unroll
      for (int e = 0; e < ENV_BATCH; ++e) v[e] = X[j + e];
#pragma unroll
      for (int e = 0; e < ENV_BATCH; ++e) {
        p = ext<T, MAX>(p, v[e]);
        if (j + e >= w2) P[j + e - w2] = ext<T, MAX>(p, j + e < cross ? mid1 : mid2);
      }
    }
    for (; j < j1; ++j) {
      p = ext<T, MAX>(p, X[j]);
      if (j >= w2) P[j - w2] = ext<T, MAX>(p, j < cross ? mid1 : mid2);
    }
  }
  __syncwarp();
  int i0 = 0, nv = 0;
  if (vec) {
    i0 = min(head_elems(out), n);
    nv = (n - i0) / V;
  }
  for (int i = lane; i < i0; i += 32) out[i] = ext<T, MAX>(S[i], P[i]);
  for (int t = lane; t < nv; t += 32) {
    const int i = i0 + t * V;
    const Vec16<T> a = *reinterpret_cast<const Vec16<T>*>(S + i);
    const Vec16<T> b = *reinterpret_cast<const Vec16<T>*>(P + i);
    Vec16<T> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = ext<T, MAX>(a.v[e], b.v[e]);
    store_streaming(out + i, o);
  }
  for (int i = i0 + nv * V + lane; i < n; i += 32) out[i] = ext<T, MAX>(S[i], P[i]);
  __syncwarp();  // S, P and cm are rewritten by the next side
}

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

// Rows row0, row0 + stride, ... one warp each; nbuf = 2 copies the next
// row while the current one is worked on, nbuf = 1 copies each row when
// its turn comes (rows whose two buffers would not fit).
template <typename T>
__global__ void __launch_bounds__(32 * ENV_MAX_WARPS)
envelope_kernel(const T* __restrict__ x, T* __restrict__ u, T* __restrict__ l,
                int64_t rows, int n, int w, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = 16 / sizeof(T);
  const EnvLayout<T> g(n, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  T* base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * g.per_warp(nbuf);
  T* const xbuf0 = base;
  T* const xbuf1 = base + (size_t)(nbuf - 1) * g.xlen;  // xbuf0 when nbuf = 1
  T* sbuf = base + (size_t)nbuf * g.xlen;
  T* pbuf = sbuf + g.olen;
  T* cm = pbuf + g.olen;
  // 16-byte stores where U's and L's rows share their alignment
  const bool vec = ((reinterpret_cast<uintptr_t>(u) ^ reinterpret_cast<uintptr_t>(l)) & 15) == 0;
  const int64_t stride = (int64_t)gridDim.x * warps;
  int64_t row = (int64_t)blockIdx.x * warps + warp;
  if (nbuf == 2 && row < rows) stage_row_async(xbuf0, x + row * n, n, w, lane);
  cp_async_commit();
  for (int it = 0; row < rows; ++it, row += stride) {
    T* buf = (it & 1) ? xbuf1 : xbuf0;
    const T* src = x + row * n;
    if (nbuf == 1) {
      stage_row_async(buf, src, n, w, lane);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      const int64_t next = row + stride;
      if (next < rows) stage_row_async((it & 1) ? xbuf0 : xbuf1, x + next * n, n, w, lane);
      cp_async_commit();
      cp_async_wait<1>();  // all but the group just committed: this row
    }
    __syncwarp();
    T* X = buf + row_shift(src, w);
    const T first = X[w], last = X[w + n - 1];
    for (int j = lane; j < w; j += 32) X[j] = first;
    for (int j = w + n + lane; j < g.nck * g.chunk; j += 32) X[j] = last;
    __syncwarp();
    T* ur = u + row * n;
    const int osh = vec ? (V - head_elems(ur) % V) % V : 0;
    envelope_side<T, true>(X, g, sbuf + osh, pbuf + osh, cm, ur, vec, lane);
    envelope_side<T, false>(X, g, sbuf + osh, pbuf + osh, cm, l + row * n, vec, lane);
  }
  cp_async_wait<0>();
}

template <typename T>
int envelope_launch(const void* x, void* u, void* l, int64_t rows, int n, int w,
                    cudaStream_t stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  if (w < 1 || w > n - 1) return (int)cudaErrorInvalidValue;
  const size_t row_smem = sizeof(T) * 4 * (size_t)(n + 2 * w);
  if (rows <= ENV_SMALL_ROWS && row_smem <= ENV_SMEM_LIMIT) {
    cudaError_t err = allow_smem(envelope_rows_kernel<T>, row_smem);
    if (err != cudaSuccess) return (int)err;
    envelope_rows_kernel<T><<<(unsigned)rows, ENV_ROW_THREADS, row_smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(u), static_cast<T*>(l), n, w);
    return (int)cudaGetLastError();
  }
  const EnvLayout<T> g(n, w);
  int nbuf = 2;
  size_t warp_bytes = sizeof(T) * g.per_warp(2);
  if (warp_bytes > ENV_SMEM_LIMIT) {
    nbuf = 1;
    warp_bytes = sizeof(T) * g.per_warp(1);
  }
  if (warp_bytes > ENV_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(envelope_kernel<T>, ENV_SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  // the block size that keeps the most warps resident per SM
  int warps = 1, resident = 0;
  for (int cand = ENV_MAX_WARPS; cand >= 1; cand /= 2) {
    const size_t smem = cand * warp_bytes;
    if (smem > ENV_SMEM_LIMIT) continue;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, envelope_kernel<T>,
                                                        32 * cand, smem);
    if (err != cudaSuccess) return (int)err;
    if (cand * per_sm > resident) {
      warps = cand;
      resident = cand * per_sm;
    }
  }
  if (resident == 0) return (int)cudaErrorInvalidValue;
  const int64_t need = (rows + warps - 1) / warps;
  const int64_t fill = (int64_t)sms * (resident / warps);
  const unsigned blocks = (unsigned)(need < fill ? need : fill);
  envelope_kernel<T><<<blocks, 32 * warps, warps * warp_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(u), static_cast<T*>(l), rows, n, w, nbuf);
  return (int)cudaGetLastError();
}

}  // namespace repro

// x, u, l: (rows, n) contiguous; 1 <= w <= n - 1, anything else returns
// cudaErrorInvalidValue (at w = 0, U = L = x: the wrapper's envelope_op
// returns (x, x) without a launch).  So does a row whose buffers do not
// fit one block's shared memory.  A batch of up to ENV_SMALL_ROWS rows
// whose padded row fits 4 times in a block's shared memory runs a block
// per row; any other, a warp per row.
extern "C" int repro_envelope(int dtype, const void* x, void* u, void* l,
                              int64_t rows, int n, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return repro::envelope_launch<float>(x, u, l, rows, n, w, s);
    case 1: return repro::envelope_launch<double>(x, u, l, rows, n, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
