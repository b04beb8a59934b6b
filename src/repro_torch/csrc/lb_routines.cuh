// The two passes of LB_Improved as device routines (CUDA C++ for sm_90a).
//
// keogh_pair is pass 1 of one (query, candidate) pair on one warp, the
// body of K4's pass 1 (lb_fused.cu); keogh_pair_batched adds the same
// terms in the same order with batched loads and streaming stores, the
// body of K2 (lb_keogh.cu, dense, pair-list and stream entries).  Pass 2
// sums the terms of one row in a fixed order, that of a block of
// PASS2_THREADS threads (thread t adds elements
// t, t + 256, ..., then a warp butterfly and the eight warps' partials in
// order): improved_terms adds them so on one warp from the row's
// envelope, the body of K3 (lb_improved.cu, the envelope by
// env_scan.cuh) and of K4's long-row pass 2; improved_pair builds the
// envelope another way (chunk_extrema) and adds the same terms in the
// same order, the body of K4's pass 2.  So K4's lb1 is bit-equal to K2's
// lb and its lb to K2's lb plus K3's lb2.
#pragma once

#include "common.cuh"

namespace repro {

// Threads of a pass-2 block; the block reduction's order depends on it.
constexpr int PASS2_THREADS = 256;
// Elements a lane of K2 loads before it runs them through its sum.
constexpr int KEOGH_BATCH = 8;

// Pass 1 on one warp: lanes stride the row (coalesced), accumulate the
// powered LB_Keogh terms of candidate row cr against the envelope rows
// ur, lr, and write the projection H = clip(c, L, U) to hr.  Returns the
// warp-reduced bound in every lane.  With EXT the same sweep also takes
// the row's max and min into mx and mn (every lane; K4's kim entry),
// which changes no term of the bound.
template <typename T, int P, bool EXT = false>
__device__ __forceinline__ T keogh_pair(const T* __restrict__ cr,
                                        const T* __restrict__ ur,
                                        const T* __restrict__ lr,
                                        T* __restrict__ hr, int n, int lane,
                                        T* mx = nullptr, T* mn = nullptr) {
  T acc = T(0);
  T hi = -pos_inf<T>(), lo = pos_inf<T>();
  for (int i = lane; i < n; i += 32) {
    const T v = cr[i], uu = ur[i], ll = lr[i];
    const T d = tmax(v - uu, T(0)) + tmax(ll - v, T(0));
    acc = combine<T, P>(acc, cost_of<T, P>(d));
    hr[i] = tmin(tmax(v, ll), uu);
    if constexpr (EXT) {
      hi = tmax(hi, v);
      lo = tmin(lo, v);
    }
  }
  if constexpr (EXT) {
    *mx = warp_reduce<T, 0>(hi);
    *mn = warp_min(lo);
  }
  return warp_reduce<T, P>(acc);
}

// Pass 1 as K2 runs it: keogh_pair's terms in keogh_pair's order (lane l
// adds elements l, l + 32, ... one after another), with the loads of
// KEOGH_BATCH elements issued before their arithmetic (the last batch
// predicated, so no element waits for its own round trip), the rows read
// through the read-only path (a block's warps share the query's U and L
// rows, which stay in L1), and H written with streaming stores (st.cs:
// written once, read by K3 later, so it should not evict the candidate
// rows from L2).  Bit-equal to keogh_pair.  With CH the candidate row is
// not contiguous: it is a flat row of n / seg channel segments of seg
// values each, segment k starting at cr + k * cstride (K7's channel
// entry, whose windows of a (d, L) segment are never copied out); the
// terms and their order are those of the gathered flat row.
template <typename T, int P, bool CH = false>
__device__ __forceinline__ T keogh_pair_batched(const T* __restrict__ cr,
                                                const T* __restrict__ ur,
                                                const T* __restrict__ lr,
                                                T* __restrict__ hr, int n, int lane,
                                                int seg = 0, int64_t cstride = 0) {
  T acc = T(0);
  for (int base = lane; base < n; base += 32 * KEOGH_BATCH) {
    T v[KEOGH_BATCH], uu[KEOGH_BATCH], ll[KEOGH_BATCH];
#pragma unroll
    for (int e = 0; e < KEOGH_BATCH; ++e) {
      const int i = base + 32 * e;
      const bool in = i < n;
      if constexpr (CH) {
        v[e] = in ? __ldg(cr + (i / seg) * cstride + i % seg) : T(0);
      } else {
        v[e] = in ? __ldg(cr + i) : T(0);
      }
      uu[e] = in ? __ldg(ur + i) : T(0);
      ll[e] = in ? __ldg(lr + i) : T(0);
    }
#pragma unroll
    for (int e = 0; e < KEOGH_BATCH; ++e) {
      const int i = base + 32 * e;
      if (i < n) {
        const T d = tmax(v[e] - uu[e], T(0)) + tmax(ll[e] - v[e], T(0));
        acc = combine<T, P>(acc, cost_of<T, P>(d));
        __stcs(hr + i, tmin(tmax(v[e], ll[e]), uu[e]));
      }
    }
  }
  return warp_reduce<T, P>(acc);
}

// Pass 2 of one row on one warp from its envelope U, L (n values each):
// lane l adds the powered distance terms of query row qr at elements l,
// l + 32, ... into accumulator (i / 32) % 8, that is those of virtual
// thread t = i % 256 of a PASS2_THREADS block in that thread's order;
// each accumulator is reduced by the warp butterfly and the eight partials
// are combined in order.  Every lane gets the result.
template <typename T, int P>
__device__ __forceinline__ T improved_terms(const T* U, const T* L,
                                            const T* __restrict__ qr, int n, int lane) {
  constexpr int VW = PASS2_THREADS / 32;
  T acc[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) acc[j] = T(0);
  for (int base = 0; base < n; base += PASS2_THREADS) {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const int i = base + 32 * j + lane;
      if (i < n) {
        const T v = qr[i];
        const T d = tmax(v - U[i], T(0)) + tmax(L[i] - v, T(0));
        acc[j] = combine<T, P>(acc[j], cost_of<T, P>(d));
      }
    }
  }
  T r = warp_reduce<T, P>(acc[0]);
#pragma unroll
  for (int j = 1; j < VW; ++j) r = combine<T, P>(r, warp_reduce<T, P>(acc[j]));
  return r;
}

// The band-w envelope of a row on one warp, by chunks: the row padded with
// w identity values on each side (lp = n + 2w values) is cut into 32
// chunks of C values, lane c's chunk at [cC, cC + C).  One pass per lane
// writes each chunk's running max and min forward (P) and backward (S);
// a window [a, b] of win = 2w + 1 > C values then spans two or more
// chunks, and its max is max(S[a], P[b], the middle chunks' maxima).
// The middle run of chunks has K - 1 or K members, K = (win - 1) / C, so
// one level of a sparse table over the chunk maxima, kept in registers
// (lane c: chunks c .. c + span - 1) and read by shuffles, covers it with
// two overlapping lookups.  Max and min are exact, so the envelope equals
// the doubling's (sliding_extrema); a lane runs about 2C dependent steps
// instead of the doubling's log2(win) levels of lp / 32 rounds.  `buf`
// holds 4 lp values; the warp's lanes all call it and all call at()
// together.
template <typename T> struct ChunkExtrema {
  const T* phi;
  const T* plo;
  const T* shi;
  const T* slo;
  int chunk, win, span;
  T thi, tlo;  // extremes of chunks lane .. lane + span - 1
  __device__ __forceinline__ void at(int i, T& u, T& l) const {
    const int a = i, b = i + win - 1;
    const int first = a / chunk + 1, last = b / chunk - 1;  // middle chunks
    const T h1 = __shfl_sync(0xffffffffu, thi, first & 31);
    const T h2 = __shfl_sync(0xffffffffu, thi, (last - span + 1) & 31);
    const T l1 = __shfl_sync(0xffffffffu, tlo, first & 31);
    const T l2 = __shfl_sync(0xffffffffu, tlo, (last - span + 1) & 31);
    u = tmax(shi[a], phi[b]);
    l = tmin(slo[a], plo[b]);
    if (last >= first) {
      u = tmax(u, tmax(h1, h2));
      l = tmin(l, tmin(l1, l2));
    }
  }
};

// Whether chunk_extrema serves this row: every window spans two chunks.
// A narrower window (2w + 1 <= C, so at most C values of a row with
// 32 C >= n) is scanned directly on the row by window_extrema.
__device__ __forceinline__ bool chunked_envelope(int n, int w) {
  return 2 * w + 1 > (n + 2 * w + 31) / 32;
}

template <typename T>
__device__ __forceinline__ void window_extrema(const T* x, int n, int w, int i, T& u,
                                               T& l) {
  const int j0 = i - w > 0 ? i - w : 0, j1 = i + w < n - 1 ? i + w : n - 1;
  u = -pos_inf<T>();
  l = pos_inf<T>();
  for (int j = j0; j <= j1; ++j) {
    u = tmax(u, x[j]);
    l = tmin(l, x[j]);
  }
}

template <typename T>
__device__ __forceinline__ ChunkExtrema<T> chunk_extrema(const T* x, int n, int w,
                                                         T* buf, int lane) {
  const int lp = n + 2 * w, win = 2 * w + 1;
  const int chunk = (lp + 31) / 32;
  T* phi = buf;
  T* plo = buf + lp;
  T* shi = buf + 2 * lp;
  T* slo = buf + 3 * lp;
  const int c0 = lane * chunk;
  const int c1 = c0 + chunk < lp ? c0 + chunk : lp;
  T hi = -pos_inf<T>(), lo = pos_inf<T>();
  for (int j = c0; j < c1; ++j) {
    const bool in = j >= w && j < w + n;
    const T v = in ? x[j - w] : T(0);
    hi = in ? tmax(hi, v) : hi;
    lo = in ? tmin(lo, v) : lo;
    phi[j] = hi;
    plo[j] = lo;
  }
  T thi = hi, tlo = lo;  // the chunk's own extremes
  hi = -pos_inf<T>();
  lo = pos_inf<T>();
  for (int j = c1 - 1; j >= c0; --j) {
    const bool in = j >= w && j < w + n;
    const T v = in ? x[j - w] : T(0);
    hi = in ? tmax(hi, v) : hi;
    lo = in ? tmin(lo, v) : lo;
    shi[j] = hi;
    slo[j] = lo;
  }
  // one sparse-table level: span = the largest power of two <= K - 1
  // (1 when K <= 2), K = (win - 1) / chunk; lanes past chunk 31 keep
  // their own value, and no lookup reaches past the last chunk
  const int k = (win - 1) / chunk;
  int span = 1;
  while (2 * span <= k - 1) span *= 2;
  for (int s = 1; s < span; s *= 2) {
    thi = tmax(thi, __shfl_down_sync(0xffffffffu, thi, s));
    tlo = tmin(tlo, __shfl_down_sync(0xffffffffu, tlo, s));
  }
  __syncwarp();
  return ChunkExtrema<T>{phi, plo, shi, slo, chunk, win, span, thi, tlo};
}

// Pass 2 of one pair on one warp, bit-equal to improved_terms: the envelope
// of h in the warp's own `buf` (4 * (n + 2w) values, warp barriers only;
// by chunks when every window spans two chunks, else scanned directly;
// one branch per row, since a test per element inside the unrolled
// chunked loop slowed it by a third), then
// the terms of virtual thread t = 32 j + lane of a PASS2_THREADS block
// summed in accumulator j in that thread's order (elements t, t + 256,
// ...), each accumulator reduced by the warp butterfly and the eight
// partials combined in order.  Every lane gets the result.
template <typename T, int P>
__device__ __forceinline__ T improved_pair(const T* h, const T* __restrict__ qr,
                                           int n, int w, T* buf, int lane) {
  constexpr int VW = PASS2_THREADS / 32;
  T acc[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) acc[j] = T(0);
  if (chunked_envelope(n, w)) {
    const ChunkExtrema<T> ext = chunk_extrema(h, n, w, buf, lane);
    for (int base = 0; base < n; base += PASS2_THREADS) {
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const int i = base + 32 * j + lane;
        T u, l;
        ext.at(i < n ? i : n - 1, u, l);  // every lane: the lookups shuffle
        if (i < n) {
          const T v = qr[i];
          const T d = tmax(v - u, T(0)) + tmax(l - v, T(0));
          acc[j] = combine<T, P>(acc[j], cost_of<T, P>(d));
        }
      }
    }
  } else {
    for (int base = 0; base < n; base += PASS2_THREADS) {
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const int i = base + 32 * j + lane;
        if (i < n) {
          T u, l;
          window_extrema(h, n, w, i, u, l);
          const T v = qr[i];
          const T d = tmax(v - u, T(0)) + tmax(l - v, T(0));
          acc[j] = combine<T, P>(acc[j], cost_of<T, P>(d));
        }
      }
    }
  }
  T r = warp_reduce<T, P>(acc[0]);
#pragma unroll
  for (int j = 1; j < VW; ++j) r = combine<T, P>(r, warp_reduce<T, P>(acc[j]));
  return r;
}

}  // namespace repro
