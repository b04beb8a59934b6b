// The band-w envelope of a row on one warp by chunked van Herk-Gil-Werman
// scans (CUDA C++ for sm_90a): the body of K1's warp per row
// (envelope.cu), of K3 (lb_improved.cu) and of K4's long-row pass 2
// (lb_fused.cu).
//
// A row of n values is staged in a buffer X padded with w copies of its
// first and last value: every window that reaches a pad holds that edge
// value already, so the pads change no extreme.  The padded row (lp =
// n + 2w values) is cut into chunks of C values, C odd (32 lanes at a
// stride of C hit 32 banks) and at most 2w - 1 (so every window spans
// two chunks); lane c takes chunks c, c + 32, ...  Per side (max for U,
// min for L) one backward pass per chunk writes the suffix extremes S and
// the chunk's extreme, and one forward pass the prefix extremes joined
// with the whole chunks that lie between the window's ends; the extreme
// over the window [i, i + 2w] of the padded row is then ext(S[i], P[i]).
// Max and min are exact, so the envelope is bit-equal to any other exact
// construction (the doubling of common.cuh, the plain PyTorch version).
//
// The buffers of one warp (EnvLayout) live in shared memory where they
// fit and otherwise in a slice of a device workspace that the wrapper
// allocates (the long-row path): the same routines run on either, with
// warp barriers only.
#pragma once

#include "common.cuh"

namespace repro {

// Warps per block of a warp-per-row launch, at most; fewer where a
// warp's buffers are large.
constexpr int ENV_MAX_WARPS = 4;
// Values a lane loads before it runs them through a scan's chain.
constexpr int ENV_BATCH = 8;
// Blocks of ENV_MAX_WARPS warps of a long-row launch (buffers in the
// workspace), at most: the workspace holds one warp's buffers per warp.
constexpr int64_t ENV_LONG_BLOCKS = 128;

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
  // w = 0 (K3's envelope is the row itself) keeps chunks of one value
  __host__ __device__ EnvLayout(int n_, int w_) : n(n_), w(w_) {
    chunk = w > 0 ? env_chunk(n, w) : 1;
    nck = (n + 2 * w + chunk - 1) / chunk;
    xlen = (nck * chunk + V - 1 + V - 1) / V * V;
    olen = (n + V - 1 + V - 1) / V * V;
    cmlen = (nck + V - 1) / V * V;
  }
  __host__ __device__ size_t per_warp(int nbuf) const {
    return (size_t)nbuf * xlen + 2 * (size_t)olen + cmlen;
  }
};

// Staged rows of a warp-per-row launch: 2 (the next row copied while the
// current one is worked on), 1, or 0 for the long-row path (the buffers
// in the workspace).
template <typename T> inline int env_nbuf(int n, int w) {
  const EnvLayout<T> g(n, w);
  if (sizeof(T) * g.per_warp(2) <= SMEM_LIMIT) return 2;
  if (sizeof(T) * g.per_warp(1) <= SMEM_LIMIT) return 1;
  return 0;
}

// Blocks of a long-row launch of `rows` rows.
inline int64_t env_long_blocks(int64_t rows) {
  const int64_t need = (rows + ENV_MAX_WARPS - 1) / ENV_MAX_WARPS;
  return need < ENV_LONG_BLOCKS ? need : ENV_LONG_BLOCKS;
}

// Bytes of workspace a warp-per-row launch of `rows` rows needs: 0 unless
// one warp's buffers overflow shared memory.
template <typename T> inline size_t env_workspace_bytes(int64_t rows, int n, int w) {
  if (rows <= 0 || w < 0 || w > n - 1 || env_nbuf<T>(n, w) > 0) return 0;
  return sizeof(T) * (size_t)env_long_blocks(rows) * ENV_MAX_WARPS *
         EnvLayout<T>(n, w).per_warp(1);
}

// The launch shape of a warp-per-row kernel whose warps take warp_bytes
// of shared memory each: the block size (up to ENV_MAX_WARPS warps) that
// keeps the most warps resident per SM, and just enough blocks to fill
// the card once (or to give every row a warp).
template <typename K>
inline cudaError_t env_grid(K kernel, size_t warp_bytes, int64_t rows, int& warps,
                            unsigned& blocks) {
  cudaError_t err = allow_smem(kernel, SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  int resident = 0;
  warps = 1;
  for (int cand = ENV_MAX_WARPS; cand >= 1; cand /= 2) {
    const size_t smem = cand * warp_bytes;
    if (smem > SMEM_LIMIT) continue;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * cand, smem);
    if (err != cudaSuccess) return err;
    if (cand * per_sm > resident) {
      warps = cand;
      resident = cand * per_sm;
    }
  }
  if (resident == 0) return cudaErrorInvalidValue;
  const int64_t need = (rows + warps - 1) / warps;
  const int64_t fill = (int64_t)sms * (resident / warps);
  blocks = (unsigned)(need < fill ? need : fill);
  return cudaSuccess;
}

template <typename T> struct alignas(16) Vec16 { T v[16 / sizeof(T)]; };

// A 16-byte store marked evict-first (st.global.cs): the value is written
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
// buf (shared memory): 16-byte copies from its first aligned value on,
// single values before and after.  The caller commits the group.
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

// The same copy into a buffer in the workspace (device memory), by plain
// loads and stores: the long-row path.
template <typename T>
__device__ __forceinline__ void stage_row_copy(T* buf, const T* __restrict__ src, int n,
                                               int w, int lane) {
  T* dst = buf + row_shift(src, w) + w;
  for (int m = lane; m < n; m += 32) dst[m] = src[m];
}

// Fill the pads of the padded row X (row at X[w .. w + n - 1], nck *
// chunk values in all) with the row's edge values.  Warp barriers on
// both sides.
template <typename T>
__device__ __forceinline__ void pad_row(T* X, const EnvLayout<T>& g, int lane) {
  __syncwarp();
  const int n = g.n, w = g.w;
  const T first = X[w], last = X[w + n - 1];
  for (int j = lane; j < w; j += 32) X[j] = first;
  for (int j = w + n + lane; j < g.nck * g.chunk; j += 32) X[j] = last;
  __syncwarp();
}

// Backward pass of one side over the padded row X: S[i] (i < n) the
// extreme of X[i .. the end of i's chunk], cm[k] chunk k's extreme.  Both
// passes load ENV_BATCH values before they run them through the chain,
// the last batch of a chunk predicated (identity values past its end).
template <typename T, bool MAX>
__device__ __forceinline__ void suffix_pass(const T* __restrict__ X, const EnvLayout<T>& g,
                                            T* __restrict__ S, T* __restrict__ cm, int lane) {
  const int n = g.n, C = g.chunk, nck = g.nck;
  for (int k = lane; k < nck; k += 32) {  // suffix extremes; the chunk's own
    const int j0 = k * C;
    T s = ext_id<T, MAX>();
    for (int j = j0 + C - 1; j >= j0; j -= ENV_BATCH) {  // loads first, then the chain
      T v[ENV_BATCH];
#pragma unroll
      for (int e = 0; e < ENV_BATCH; ++e) v[e] = j - e >= j0 ? X[j - e] : ext_id<T, MAX>();
#pragma unroll
      for (int e = 0; e < ENV_BATCH; ++e) {
        s = ext<T, MAX>(s, v[e]);
        if (j - e >= j0 && j - e < n) S[j - e] = s;
      }
    }
    cm[k] = s;
  }
}

// Forward pass of one side: for b = i + 2w, the extreme of X[the start of
// b's chunk .. b] and of every chunk strictly between i's and b's, written
// to P[i], or, with JOIN, joined with S[i] in place (S[i] becomes the
// envelope value).  Reads the cm and S of suffix_pass: a warp barrier
// between the two.
template <typename T, bool MAX, bool JOIN>
__device__ __forceinline__ void prefix_pass(const T* __restrict__ X, const EnvLayout<T>& g,
                                            T* S, T* P, const T* __restrict__ cm, int lane) {
  const int n = g.n, w2 = 2 * g.w, C = g.chunk, nck = g.nck, lp = n + w2;
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
    for (int j = j0; j < j1; j += ENV_BATCH) {
      T v[ENV_BATCH];
#pragma unroll
      for (int e = 0; e < ENV_BATCH; ++e) v[e] = j + e < j1 ? X[j + e] : ext_id<T, MAX>();
#pragma unroll
      for (int e = 0; e < ENV_BATCH; ++e) {
        p = ext<T, MAX>(p, v[e]);
        if (j + e < j1 && j + e >= w2) {
          const T pv = ext<T, MAX>(p, j + e < cross ? mid1 : mid2);
          if (JOIN) S[j + e - w2] = ext<T, MAX>(S[j + e - w2], pv);
          else P[j + e - w2] = pv;
        }
      }
    }
  }
}

// One side of the envelope of the padded row X into out (n values, device
// memory): U for MAX, else L.  out[i] = ext(S[i], P[i]) covers X[i ..
// i + 2w] exactly once over, written with 16-byte streaming stores where
// `vec` (S and P are then 16-byte aligned at out's first aligned index).
template <typename T, bool MAX>
__device__ void envelope_side(const T* __restrict__ X, const EnvLayout<T>& g,
                              T* __restrict__ S, T* __restrict__ P, T* __restrict__ cm,
                              T* __restrict__ out, bool vec, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int n = g.n;
  suffix_pass<T, MAX>(X, g, S, cm, lane);
  __syncwarp();
  prefix_pass<T, MAX, false>(X, g, S, P, cm, lane);
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

// One side of the envelope of the padded row X into E (n values, in the
// warp's own buffers): U for MAX, else L, joined in place.  Ends with a
// warp barrier.
template <typename T, bool MAX>
__device__ __forceinline__ void envelope_join(const T* __restrict__ X, const EnvLayout<T>& g,
                                              T* E, T* cm, int lane) {
  suffix_pass<T, MAX>(X, g, E, cm, lane);
  __syncwarp();
  prefix_pass<T, MAX, true>(X, g, E, nullptr, cm, lane);
  __syncwarp();  // E complete; cm is rewritten by the next side
}

// Rows row0, row0 + stride, ... of x (rows, n), one warp each: each row
// staged into the warp's padded buffer X (the first nbuf * xlen values at
// `base`), then body(row, X).  In shared memory (LONG false) nbuf = 2
// copies the next row with cp.async while the current one is worked on,
// nbuf = 1 copies each row when its turn comes; in the workspace (LONG,
// nbuf = 1) each row is copied by plain loads and stores.  The body ends
// with a warp barrier: the buffers are rewritten for the next row.
template <typename T, bool LONG, typename F>
__device__ __forceinline__ void warp_rows(const T* __restrict__ x, int64_t rows,
                                          const EnvLayout<T>& g, int nbuf, T* base,
                                          F&& body) {
  const int n = g.n, w = g.w;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  T* const xbuf0 = base;
  T* const xbuf1 = base + (size_t)(nbuf - 1) * g.xlen;  // xbuf0 when nbuf = 1
  const int64_t stride = (int64_t)gridDim.x * warps;
  int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
  if constexpr (!LONG) {
    if (nbuf == 2 && row < rows) stage_row_async(xbuf0, x + row * n, n, w, lane);
    cp_async_commit();
  }
  for (int it = 0; row < rows; ++it, row += stride) {
    T* buf = (it & 1) ? xbuf1 : xbuf0;
    const T* src = x + row * n;
    if constexpr (LONG) {
      stage_row_copy(buf, src, n, w, lane);
    } else if (nbuf == 1) {
      stage_row_async(buf, src, n, w, lane);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      const int64_t next = row + stride;
      if (next < rows) stage_row_async((it & 1) ? xbuf0 : xbuf1, x + next * n, n, w, lane);
      cp_async_commit();
      cp_async_wait<1>();  // all but the group just committed: this row
    }
    T* X = buf + row_shift(src, w);
    pad_row(X, g, lane);
    body(row, X);
  }
  if constexpr (!LONG) cp_async_wait<0>();
}

}  // namespace repro
