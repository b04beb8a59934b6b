// K5: banded DTW_p with a per-lane abandon bound (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/dtw/kernel.py: dtw_banded_pallas
// (_dtw_lane, _dtw_kernel, _dtw_db_kernel).
//
// For each (query, candidate) pair the band DP of half-width w runs over
// the anti-diagonals s = i + j, s = 0 .. 2n-2.  Cell (i, j) with offset
// e = i - j in [-w, w] needs diagonal s-1 at offsets e-1 (up, (i-1, j))
// and e+1 (left, (i, j-1)) and diagonal s-2 at offset e (diag), so the
// cells of one diagonal are independent of each other.  Cells are
//   D[i,j] = min(cost(q_i - c_j) + min(up, left, diag), BIG)   (p = 1, 2)
//   D[i,j] = min(max(|q_i - c_j|, min(up, left, diag)), BIG)   (p = inf)
// with powered costs; cells outside the band or the grid hold BIG.  The
// sums and products are rounded one by one (__fadd_rn, __fmul_rn), so no
// fused multiply-add changes a bit: a lane that runs to the end returns
// the value of repro_torch.core.dtw.dtw_banded_diag(..., powered=True)
// bit for bit, at p in {1, 2, inf} in float and double.
//
// Abandon rule.  With bounds, before step 0 and every ABANDON_EVERY steps
// the lane takes the minimum over the cells of the two latest diagonals
// and stops if it is >= its bound, returning that minimum.  Every warping
// path crosses one of two consecutive anti-diagonals and accumulated
// costs never fall along a path, so the stopped lane's distance is >= the
// returned value >= the bound.  This minimum is not the row minimum the
// reference's row DP returns; callers are promised only "abandoned =>
// value >= bound" (kernels/dtw/ops.py::dtw_wavefront_plain repeats the
// rule).  Without bounds no test runs.  A bound of BIG never stops a lane.
//
// Bound on this card: at the host driver's chunks (at most 16 pairs, one
// warp each, on 132 SMs) nothing hides latency, so the time is the
// (2n-1)-step dependency chain of one pair; dense launches (the brute
// force over 100,000 rows) are bound by operations.  Design: one warp per
// pair, and only the w+1 (or w) cells of a diagonal's parity are kept:
// slot t holds offset e = -w + par + 2t, par = (s + w) & 1.  A diagonal
// of parity 0 reads slots t-1 (up) and t (left) of the one before it, a
// diagonal of parity 1 slots t and t+1.  Each lane holds S contiguous
// slots of the two latest diagonals in registers and updates the older
// one in place, so a step's chain is one shuffle of an edge value (up on
// parity 0, down on parity 1), two mins, an add and the clamp.  S is a
// template value, the smallest power of two with 32 S >= w + 1, up to 16
// (w <= 511); wider bands run the same wavefront with the two diagonals
// in shared memory (S = 0).  The query and candidate rows are staged
// once in shared memory with 16-byte loads and padded with +-ROW_PAD,
// whose cost exceeds BIG, so a cell off the grid needs no test.  In the
// register path the q and c values of a lane's cells are sliding windows
// in registers: from one diagonal to the next only one of them moves by
// one element, so a step loads one value, a step ahead.  Steps run in
// unrolled blocks of 2S, after which the windows are back in place.
// Long rows, whose two staged rows (and diagonals) overflow a block's
// shared memory, take one more instantiation per dtype and p, chosen by
// shape (S = LONG_ROWS): the shared-memory wavefront with the rows read
// in place from device memory through L1, the +-ROW_PAD sentinels applied
// by index, and the two diagonals in shared memory, or, past 2 (w + 3)
// values, in a workspace slice per pair (the entries' workspace).  Its
// cells are the same, so it is bit-equal to the staged paths.
//
// The channel entry (d > 1).  Rows are dependent multivariate series in
// the channel-major flattened layout, d contiguous segments of n values
// (repro_torch/mv/layout.py), one shared warping path over n x n cells.
// A cell's cost is the channel sum of pair_cost (the max at p = inf),
// combined in channel order with one rounding each, before dp_cell; the
// rest of the DP is the one above, so a lane that runs to the end returns
// the value of kernels/dtw/ops.py::dtw_wavefront_plain(d=...) bit for bit.
// It runs the shared-memory wavefront (S = CHANNELS): each channel
// segment staged with its own +-ROW_PAD margins, so index i - 1 of
// channel 1 is a pad and not channel 0's last sample, and an off-grid
// cell costs >= BIG in every channel (at p = 2 the square may overflow to
// +inf; the sum stays +inf and the clamp makes the cell BIG).  Where the
// d rows of each side and the diagonals overflow a block's shared
// memory, the rows are read in place with the pads applied by index (S =
// CHANNELS_LONG), the diagonals as on the long-row path.  d = 1 never
// takes these paths: it launches the univariate instantiations.
#include "block_merge.cuh"

namespace repro {

// Steps between two abandon tests: a multiple of every block of 2S steps.
constexpr int ABANDON_EVERY = 32;
// Largest register slot count per lane; wider bands use shared memory.
constexpr int MAX_SLOTS = 16;
// The slot count that selects the long-row path.
constexpr int LONG_ROWS = -1;
// The slot counts of the channel entry (d > 1): the shared-memory
// wavefront over staged channel segments, or over rows read in place.
constexpr int CHANNELS = -2;
constexpr int CHANNELS_LONG = -3;

__host__ __device__ constexpr bool channel_path(int s) {
  return s == CHANNELS || s == CHANNELS_LONG;
}

// Row padding: |ROW_PAD - x| and |x + ROW_PAD| exceed BIG for any row
// value |x| < 1e34, so a cell with i or j outside 0..n-1 costs >= BIG and
// its value is BIG at every p (the square may overflow to +inf, which the
// clamp turns into BIG).
template <typename T> __device__ __forceinline__ T row_pad() { return T(1.0e35); }

// min and max as one FMNMX / DMNMX each.  They differ from tmin / tmax
// only on NaN and on the sign of zero, and neither occurs in the DP: every
// value is +0 or positive (costs are |q - c| or its square, BIG is
// finite, a square may overflow to +inf but nothing subtracts it).
template <typename T> __device__ __forceinline__ T dmin(T a, T b) { return fmin(a, b); }
template <typename T> __device__ __forceinline__ T dmax(T a, T b) { return fmax(a, b); }

template <typename T, int P> __device__ __forceinline__ T pair_cost(T q, T c) {
  const T d = fabs(q - c);
  return P == 2 ? mul_rn(d, d) : d;
}

// One cell from its cost and the minimum of its three predecessors.
template <typename T, int P> __device__ __forceinline__ T dp_cell(T cost, T best) {
  return dmin(P == 0 ? dmax(cost, best) : add_rn(cost, best), big<T>());
}

// Padding on each side of a staged row: covers every index a lane reads,
// (w + 1) / 2 + S past the ends, rounded to whole 16-byte vectors.
__host__ __device__ inline int row_margin(int w, int s, int vec) {
  const int m = (w + 1) / 2 + s + 1;
  return (m + vec - 1) / vec * vec;
}

// Values per staged row, margins included, a whole number of vectors;
// at least 32 s, so the query row's buffer can take a whole diagonal.
__host__ __device__ inline int row_len(int n, int w, int s, int vec) {
  const int len = (n + 2 * row_margin(w, s, vec) + vec - 1) / vec * vec;
  return len > 32 * s ? len : 32 * s;
}

// dst[0 .. margin) and dst[margin + n .. len) = fill, dst[margin + k] =
// src[k]; 16-byte loads and stores where src is aligned (dst always is).
template <typename T>
__device__ void stage_row(T* dst, const T* __restrict__ src, int n, int margin,
                          int len, T fill, int lane) {
  constexpr int V = 16 / sizeof(T);
  for (int k = lane; k < margin; k += 32) dst[k] = fill;
  for (int k = margin + n + lane; k < len; k += 32) dst[k] = fill;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst + margin);
    for (int k = lane; k < nv; k += 32) d4[k] = __ldg(s4 + k);
    done = nv * V;
  }
  for (int k = done + lane; k < n; k += 32) dst[margin + k] = src[k];
}

// Steps M = B .. E-1 of a block, unrolled at compile time; with a
// `left` count only the first `left` of them run (the last block).
template <int B, int E> struct Unroll {
  template <typename W> __device__ __forceinline__ static void run(W& wave) {
    wave.template step<B>();
    Unroll<B + 1, E>::run(wave);
  }
  template <typename W> __device__ __forceinline__ static void run(W& wave, int left) {
    if (B < left) wave.template step<B>();
    Unroll<B + 1, E>::run(wave, left);
  }
};
template <int E> struct Unroll<E, E> {
  template <typename W> __device__ __forceinline__ static void run(W&) {}
  template <typename W> __device__ __forceinline__ static void run(W&, int) {}
};

// The register wavefront of one lane.  Steps with even s update `a`, odd
// s update `b`; WODD = w & 1 fixes the parity of the even steps.  The q
// values of the lane's cells are the window q[I + lo + u] and the c
// values c[J - lo - u], u = 0 .. S-1: a parity-0 step is followed by
// I += 1, a parity-1 step by J += 1.  Within a block of 2S steps, at step
// M, logical u of the q window sits in qw[(u + KQ) % S] and of the c
// window in cw[(u - KC) mod S]; after a block both are back at 0.
template <typename T, int P, int S, int WODD> struct RegWave {
  T a[S], b[S], qw[S], cw[S];
  const T* qnext;  // the value entering the q window after a parity-0 step
  const T* cnext;  // the value entering the c window after a parity-1 step
  T dead[2][S];    // 0 for a live slot on a diagonal of parity par, else BIG
  int from_left, from_right;  // lanes lane-1 and lane+1, mod 32

  __device__ __forceinline__ RegWave(const T* qb, const T* cb, int w, int lane) {
    const int lim = w - lane * S;            // slot lane*S + u is live iff u <= lim - par
    const int lo = lim >= 0 ? lane * S : 0;  // lanes past the band read lane 0's rows
    const int i0 = -(w >> 1), j0 = w >> 1;   // I and J of step 0
#pragma unroll
    for (int u = 0; u < S; ++u) {
      a[u] = lane * S + u == (w >> 1) ? T(0) : big<T>();  // diag of cell (0, 0)
      b[u] = big<T>();
      qw[u] = qb[i0 + lo + u];
      cw[u] = cb[j0 - lo - u];
      dead[0][u] = u > lim ? big<T>() : T(0);
      dead[1][u] = u > lim - 1 ? big<T>() : T(0);
    }
    qnext = qb + i0 + 1 + lo + S - 1;
    cnext = cb + j0 + 1 - lo;
    from_left = (lane + 31) & 31;
    from_right = (lane + 1) & 31;
  }

  template <int M> __device__ __forceinline__ void step() {
    if constexpr (M & 1) update<M>(b, a);
    else update<M>(a, b);
  }

  // dst: diagonal s-2, overwritten with s; src: diagonal s-1.  The edge
  // value comes from the next lane around the ring: lane 0's up is lane
  // 31's last slot, on a parity-1 diagonal always a dead slot (BIG), and
  // lane 31's last slot on a parity-1 step is dead, so its cell is BIG
  // whatever its left is.
  template <int M> __device__ __forceinline__ void update(T (&dst)[S], const T (&src)[S]) {
    constexpr int PAR = (M & 1) ^ WODD;
    constexpr int KQ = (WODD ? M / 2 : (M + 1) / 2) % S;
    constexpr int KC = (WODD ? (M + 1) / 2 : M / 2) % S;
    const T nb = PAR == 0 ? __shfl_sync(0xffffffffu, src[S - 1], from_left)
                          : __shfl_sync(0xffffffffu, src[0], from_right);
    const T pend = PAR == 0 ? *qnext : *cnext;
#pragma unroll
    for (int u = 0; u < S; ++u) {
      // a dead slot costs BIG, so its cell is BIG whatever its predecessors
      const T cost = dmax(pair_cost<T, P>(qw[(u + KQ) % S], cw[(u - KC + S) % S]),
                          dead[PAR][u]);
      // min is exact and order-free: join the lane's own values first, so
      // the shuffled edge value meets one min before the add
      const T own = dmin(dst[u], src[u]);
      const T edge = PAR == 0 ? (u == 0 ? nb : src[u == 0 ? 0 : u - 1])
                              : (u == S - 1 ? nb : src[u == S - 1 ? 0 : u + 1]);
      dst[u] = dp_cell<T, P>(cost, dmin(own, edge));
    }
    if (PAR == 0) {
      qw[KQ] = pend;  // the slot of the leaving logical 0
      ++qnext;
    } else {
      cw[(2 * S - 1 - KC) % S] = pend;  // the slot of the leaving logical S-1
      ++cnext;
    }
  }

  __device__ __forceinline__ T lane_min() const {
    T m = big<T>();
#pragma unroll
    for (int u = 0; u < S; ++u) m = tmin(m, tmin(a[u], b[u]));
    return m;
  }
};

// The register path: qb[i] and cb[j] are the staged rows, valid for
// -margin <= i < n + margin; `scratch` holds 32 S values.
template <typename T, int P, int S, int WODD>
__device__ __forceinline__ T wavefront_regs(const T* qb, const T* cb, int n, int w,
                                            bool check, T bound, T* scratch) {
  const int lane = threadIdx.x & 31;
  RegWave<T, P, S, WODD> wave(qb, cb, w, lane);
  const int nsteps = 2 * n - 1;
  int s0 = 0;
  for (; s0 < nsteps; s0 += 2 * S) {
    if (check && s0 % ABANDON_EVERY == 0) {
      const T m = warp_min(wave.lane_min());
      if (m >= bound) return m;
    }
    if (s0 + 2 * S > nsteps) {
      Unroll<0, 2 * S>::run(wave, nsteps - s0);  // the last, partial block
      break;
    }
    Unroll<0, 2 * S>::run(wave);
  }
  // diagonal 2n-2 (an even step, in a) holds cell (n-1, n-1) at slot
  // w/2.  It goes through shared memory: picking a[w/2 % S] in registers
  // compiles to an indexed load, which would move `a` to local memory.
  __syncwarp();
#pragma unroll
  for (int u = 0; u < S; ++u) scratch[lane * S + u] = wave.a[u];
  __syncwarp();
  return scratch[w >> 1];
}

// The rows of a pair, staged in shared memory with their pads (qb[i] and
// cb[j] valid for -margin <= i, j < n + margin) ...
template <typename T> struct StagedRows {
  const T* q;
  const T* c;
  __device__ __forceinline__ T qv(int i) const { return q[i]; }
  __device__ __forceinline__ T cv(int j) const { return c[j]; }
  template <int P> __device__ __forceinline__ T cost(int i, int j) const {
    return pair_cost<T, P>(qv(i), cv(j));
  }
};

// ... or read in place from device memory, the pads applied by index: the
// same value at every index the wavefront reads.
template <typename T> struct GlobalRows {
  const T* __restrict__ q;
  const T* __restrict__ c;
  int n;
  __device__ __forceinline__ T qv(int i) const {
    return (unsigned)i < (unsigned)n ? __ldg(q + i) : row_pad<T>();
  }
  __device__ __forceinline__ T cv(int j) const {
    return (unsigned)j < (unsigned)n ? __ldg(c + j) : -row_pad<T>();
  }
  template <int P> __device__ __forceinline__ T cost(int i, int j) const {
    return pair_cost<T, P>(qv(i), cv(j));
  }
};

// The channel-summed cost of cell (i, j) from the d aligned pairs of
// values (p = inf: their max), in channel order.
template <typename T, int P> __device__ __forceinline__ T join_cost(T acc, T v) {
  return P == 0 ? dmax(acc, v) : add_rn(acc, v);
}

// The d channel segments of a pair's rows staged in shared memory, each
// with its pads (channel ch of q at q[ch * len + i], -margin <= i < n +
// margin) ...
template <typename T> struct StagedChannelRows {
  const T* q;
  const T* c;
  int len;
  int d;
  template <int P> __device__ __forceinline__ T cost(int i, int j) const {
    T acc = pair_cost<T, P>(q[i], c[j]);
    for (int ch = 1; ch < d; ++ch)
      acc = join_cost<T, P>(acc, pair_cost<T, P>(q[ch * len + i], c[ch * len + j]));
    return acc;
  }
};

// ... or read in place from the flattened rows, the pads applied by index.
template <typename T> struct GlobalChannelRows {
  const T* __restrict__ q;
  const T* __restrict__ c;
  int n;
  int d;
  template <int P> __device__ __forceinline__ T cost(int i, int j) const {
    const bool qin = (unsigned)i < (unsigned)n, cin = (unsigned)j < (unsigned)n;
    T acc = T(0);
    for (int ch = 0; ch < d; ++ch) {
      const T qv = qin ? __ldg(q + (size_t)ch * n + i) : row_pad<T>();
      const T cv = cin ? __ldg(c + (size_t)ch * n + j) : -row_pad<T>();
      const T v = pair_cost<T, P>(qv, cv);
      acc = ch == 0 ? v : join_cost<T, P>(acc, v);
    }
    return acc;
  }
};

// The shared-memory wavefront for bands past the register cap and for
// long rows: the same slots, diagonals da and db (index -1 and w + 1 hold
// BIG), lane-strided slots, one __syncwarp per step.
template <typename T, int P, typename Rows>
__device__ T wavefront_smem(const Rows& rows, int n, int w, T* da, T* db, bool check,
                            T bound) {
  const int lane = threadIdx.x & 31;
  for (int t = lane - 1; t <= w + 1; t += 32) {
    da[t] = t == (w >> 1) ? T(0) : big<T>();
    db[t] = big<T>();
  }
  __syncwarp();
  const int nsteps = 2 * n - 1;
  for (int s = 0; s < nsteps; ++s) {
    if (check && s % ABANDON_EVERY == 0) {
      T lm = big<T>();
      for (int t = lane; t <= w; t += 32) lm = tmin(lm, tmin(da[t], db[t]));
      const T m = warp_min(lm);
      if (m >= bound) return m;
    }
    const int par = (s + w) & 1;
    T* dst = (s & 1) ? db : da;
    const T* src = (s & 1) ? da : db;
    const int I = (s - w + par) >> 1, J = (s + w - par) >> 1;
    for (int t = lane; t <= w; t += 32) {
      T cost = rows.template cost<P>(I + t, J - t);
      if (t > w - par) cost = big<T>();
      const T up = par ? src[t] : src[t - 1];
      const T left = par ? src[t + 1] : src[t];
      dst[t] = dp_cell<T, P>(cost, dmin(dmin(up, left), dst[t]));
    }
    __syncwarp();
  }
  return da[w >> 1];
}

// Whether the diagonals of the long-row path (2 (w + 3) values) fit in
// shared memory; if not they are a slice of the workspace per pair.
template <typename T> __host__ __device__ __forceinline__ bool long_diag_in_smem(int w) {
  return sizeof(T) * 2 * (size_t)(w + 3) <= SMEM_LIMIT;
}

// The DP of one pair on one warp: stage the two rows and run the
// wavefront.  S > 0: the band in registers, S slots per lane; S = 0: in
// shared memory; S = LONG_ROWS: the rows in place, the diagonals in shared
// memory or in the workspace slice `diag`.  S = CHANNELS and
// CHANNELS_LONG: the same two shared-memory forms over d channel
// segments (the rows are d n values).  Returns the pair's value in lane 0.
template <typename T, int P, int S>
__device__ __forceinline__ T dtw_pair(const T* __restrict__ qrow_g,
                                      const T* __restrict__ crow_g, int n, int w, int d,
                                      bool check, T bound, unsigned char* smem_raw,
                                      T* diag) {
  if constexpr (S == LONG_ROWS || S == CHANNELS_LONG) {
    T* da = (long_diag_in_smem<T>(w) ? reinterpret_cast<T*>(smem_raw) : diag) + 1;
    if constexpr (S == LONG_ROWS)
      return wavefront_smem<T, P>(GlobalRows<T>{qrow_g, crow_g, n}, n, w, da,
                                  da + (w + 3), check, bound);
    else
      return wavefront_smem<T, P>(GlobalChannelRows<T>{qrow_g, crow_g, n, d}, n, w, da,
                                  da + (w + 3), check, bound);
  } else if constexpr (S == CHANNELS) {
    constexpr int V = 16 / sizeof(T);
    const int margin = row_margin(w, 1, V);
    const int len = row_len(n, w, 1, V);
    T* qrow = reinterpret_cast<T*>(smem_raw);
    T* crow = qrow + (size_t)d * len;
    const int lane = threadIdx.x;
    for (int ch = 0; ch < d; ++ch) {
      stage_row(qrow + (size_t)ch * len, qrow_g + (size_t)ch * n, n, margin, len,
                row_pad<T>(), lane);
      stage_row(crow + (size_t)ch * len, crow_g + (size_t)ch * n, n, margin, len,
                -row_pad<T>(), lane);
    }
    __syncwarp();
    T* da = crow + (size_t)d * len + 1;
    return wavefront_smem<T, P>(StagedChannelRows<T>{qrow + margin, crow + margin, len, d},
                                n, w, da, da + (w + 3), check, bound);
  } else {
    constexpr int V = 16 / sizeof(T);
    const int margin = row_margin(w, S > 0 ? S : 1, V);
    const int len = row_len(n, w, S > 0 ? S : 1, V);
    T* qrow = reinterpret_cast<T*>(smem_raw);
    T* crow = qrow + len;
    const int lane = threadIdx.x;
    stage_row(qrow, qrow_g, n, margin, len, row_pad<T>(), lane);
    stage_row(crow, crow_g, n, margin, len, -row_pad<T>(), lane);
    __syncwarp();
    const T* qb = qrow + margin;
    const T* cb = crow + margin;
    if constexpr (S == 0) {
      T* da = crow + len + 1;
      return wavefront_smem<T, P>(StagedRows<T>{qb, cb}, n, w, da, da + (w + 3), check,
                                  bound);
    } else if (w & 1) {
      return wavefront_regs<T, P, S, 1>(qb, cb, n, w, check, bound, qrow);
    } else {
      return wavefront_regs<T, P, S, 0>(qb, cb, n, w, check, bound, qrow);
    }
  }
}

// The merge epilogue of the masked-dense entry (block_merge.cuh).  Each
// block of query q takes a ticket once its slot is written (a dead slot
// at once): lane 0 adds 1 to q's counter with release and acquire
// semantics, so the slot is visible before the ticket and every slot of
// q before the merge.  The block that takes q's nb-th ticket merges q,
// reading the slots through L2, and resets the counter.  Every block of q
// read q's bound before its ticket, so the merger's writes to top_v never
// change a bound that a DP of this launch reads.  ws: Q tickets, all 0
// between launches.  Not inlined: one copy per T serves the 27 DP
// instances of that T, and the DP's registers are dead by the call.
template <typename T>
__device__ __noinline__ void merge_epilogue(const MergeOut<T>& m,
                                            const uint8_t* __restrict__ stage, const T* out,
                                            unsigned long long* ws, int64_t nq, int64_t nb,
                                            int64_t q, int lane) {
  int last = 0;
  if (lane == 0) {
    unsigned long long old;
    asm volatile("atom.add.acq_rel.gpu.u64 %0, [%1], %2;"
                 : "=l"(old) : "l"(ws + q), "l"(1ull) : "memory");
    last = old == (unsigned long long)(nb - 1);
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  __syncwarp();  // the other lanes' reads come after lane 0's acquire
  if (!last) return;
  merge_query(m, stage, out, nq, nb, q, lane);
  if (lane == 0) ws[q] = 0;  // every block of q has taken its ticket
}

// One warp per pair.  With `stage` and merge.top_v (the masked-dense
// entry) a slot whose stage is not merge.live (a survivor's) skips the DP
// before it reads a row, and leaves its out value as it was; every slot
// then takes its ticket
// for the merge epilogue, and one block past the last slot adds the
// block's totals from the stage.  The pair-list entry passes neither.
// The bound of a pair is bounds[pair], or bounds[q * bound_qstride] when
// that stride is > 0 (a column of top_v, which the epilogue writes: no
// __restrict__).
template <typename T, int P, int S>
__global__ void __launch_bounds__(32)
dtw_kernel(const T* __restrict__ qs, const T* __restrict__ cands,
           const int64_t* __restrict__ qidx, const int64_t* __restrict__ cidx,
           const uint8_t* __restrict__ stage, const T* bounds, int64_t bound_qstride,
           int64_t bstride, int n, int w, int d, T* __restrict__ out, MergeOut<T> merge,
           unsigned long long* ws, T* __restrict__ diag_ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t pair = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t npairs = (int64_t)gridDim.x - (merge.top_v ? 1 : 0);
  if (pair == npairs) {  // the merge's totals block
    add_block_totals(merge, stage, npairs, lane);
    return;
  }
  const int64_t q = qidx ? qidx[pair] : pair / bstride;
  if (!stage || stage[pair] == merge.live) {
    const int64_t c = cidx ? cidx[pair] : pair % bstride;
    const bool check = bounds != nullptr;
    const T bound =
        !check ? big<T>() : bounds[bound_qstride > 0 ? q * bound_qstride : pair];
    T* diag = diag_ws ? diag_ws + (size_t)pair * 2 * (w + 3) : nullptr;
    const int64_t row = channel_path(S) ? (int64_t)d * n : n;  // values per row
    const T v = dtw_pair<T, P, S>(qs + q * row, cands + c * row, n, w, d, check, bound,
                                  smem_raw, diag);
    if (lane == 0) out[pair] = v;
  }
  if (merge.top_v) merge_epilogue(merge, stage, out, ws, npairs / bstride, bstride, q, lane);
}

// Dynamic shared memory of one pair's block on path S (d channel
// segments a row on the channel paths).
template <typename T> __host__ __device__ inline size_t dtw_smem(int n, int w, int S, int d) {
  if (S == LONG_ROWS || S == CHANNELS_LONG)
    return long_diag_in_smem<T>(w) ? sizeof(T) * 2 * (size_t)(w + 3) : 0;
  constexpr int V = 16 / sizeof(T);
  const size_t len = row_len(n, w, S > 0 ? S : 1, V);
  const size_t rows = S == CHANNELS ? 2 * (size_t)d : 2;
  return sizeof(T) * (rows * len + (S <= 0 ? 2 * (size_t)(w + 3) : 0));
}

template <typename T, int P, int S>
cudaError_t launch_dtw(const T* qs, const T* cands, const int64_t* qidx,
                       const int64_t* cidx, const uint8_t* stage, const T* bounds,
                       int64_t bound_qstride, int64_t npairs, int64_t bstride,
                       int n, int w, int d, T* out, const MergeOut<T>& merge,
                       unsigned long long* ws, T* diag_ws, cudaStream_t s) {
  constexpr bool in_place = S == LONG_ROWS || S == CHANNELS_LONG;
  const size_t smem = dtw_smem<T>(n, w, S, d);
  if (in_place && !long_diag_in_smem<T>(w) && diag_ws == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dtw_kernel<T, P, S>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(npairs + (merge.top_v ? 1 : 0));
  dtw_kernel<T, P, S><<<blocks, 32, smem, s>>>(
      qs, cands, qidx, cidx, stage, bounds, bound_qstride, bstride, n, w, d, out, merge, ws,
      in_place && !long_diag_in_smem<T>(w) ? diag_ws : nullptr);
  return cudaGetLastError();
}

}  // namespace repro

// The slot count per lane of the register path, 0 for the shared-memory
// path (bands wider than 32 * MAX_SLOTS cells), or LONG_ROWS where that
// path's shared memory would pass the card's limit.  d > 1: CHANNELS, or
// CHANNELS_LONG where its 2 d staged segments and diagonals would.
template <typename T> static int dtw_slots(int n, int w, int d) {
  if (d > 1)
    return repro::dtw_smem<T>(n, w, repro::CHANNELS, d) > repro::SMEM_LIMIT
               ? repro::CHANNELS_LONG
               : repro::CHANNELS;
  const int per_lane = (w + 1 + 31) / 32;
  int slots = 1;
  while (slots < per_lane) slots *= 2;
  if (slots > repro::MAX_SLOTS) slots = 0;
  const size_t smem = repro::dtw_smem<T>(n, w, slots, 1);
  return smem > repro::SMEM_LIMIT ? repro::LONG_ROWS : slots;
}

// Bytes of workspace the in-place paths need for the diagonals of npairs
// pairs (0 where neither is taken or the diagonals fit in shared memory).
template <typename T> static size_t dtw_diag_bytes(int64_t npairs, int n, int w, int d) {
  const int slots = dtw_slots<T>(n, w, d);
  if (npairs <= 0 || (slots != repro::LONG_ROWS && slots != repro::CHANNELS_LONG) ||
      repro::long_diag_in_smem<T>(w))
    return 0;
  return sizeof(T) * (size_t)npairs * 2 * (size_t)(w + 3);
}

template <typename T, int P>
static cudaError_t dtw_dispatch(const T* q, const T* c, const int64_t* qidx,
                                const int64_t* cidx, const uint8_t* stage,
                                const T* bd, int64_t bound_qstride, int64_t npairs,
                                int64_t bstride, int n, int w, int d, T* o,
                                const repro::MergeOut<T>& m, unsigned long long* ws,
                                T* dw, cudaStream_t s) {
  switch (dtw_slots<T>(n, w, d)) {
    case 1: return repro::launch_dtw<T, P, 1>(q, c, qidx, cidx, stage, bd, bound_qstride, npairs, bstride, n, w, d, o, m, ws, dw, s);
    case 2: return repro::launch_dtw<T, P, 2>(q, c, qidx, cidx, stage, bd, bound_qstride, npairs, bstride, n, w, d, o, m, ws, dw, s);
    case 4: return repro::launch_dtw<T, P, 4>(q, c, qidx, cidx, stage, bd, bound_qstride, npairs, bstride, n, w, d, o, m, ws, dw, s);
    case 8: return repro::launch_dtw<T, P, 8>(q, c, qidx, cidx, stage, bd, bound_qstride, npairs, bstride, n, w, d, o, m, ws, dw, s);
    case 16: return repro::launch_dtw<T, P, 16>(q, c, qidx, cidx, stage, bd, bound_qstride, npairs, bstride, n, w, d, o, m, ws, dw, s);
    case 0: return repro::launch_dtw<T, P, 0>(q, c, qidx, cidx, stage, bd, bound_qstride, npairs, bstride, n, w, d, o, m, ws, dw, s);
    case repro::CHANNELS: return repro::launch_dtw<T, P, repro::CHANNELS>(q, c, qidx, cidx, stage, bd, bound_qstride, npairs, bstride, n, w, d, o, m, ws, dw, s);
    case repro::CHANNELS_LONG: return repro::launch_dtw<T, P, repro::CHANNELS_LONG>(q, c, qidx, cidx, stage, bd, bound_qstride, npairs, bstride, n, w, d, o, m, ws, dw, s);
    default: return repro::launch_dtw<T, P, repro::LONG_ROWS>(q, c, qidx, cidx, stage, bd, bound_qstride, npairs, bstride, n, w, d, o, m, ws, dw, s);
  }
}

// qs (Q, d n); cands (Nc, d n); bounds (npairs,) powered, or nullptr for
// no abandon test; out (npairs,) powered.  Dense mode: qidx = cidx =
// nullptr and npairs = Q * bstride.  0 <= w <= n - 1, n the per-channel
// length.  d = 1: the register path takes S = the smallest power of two
// with 32 S >= w + 1 while S <= 16; wider bands take the shared-memory
// path; rows whose path would pass the card's shared memory take the
// long-row path, with their diagonals in `workspace` (repro_dtw_workspace
// bytes; else unused and may be null).  d > 1: the channel paths.
extern "C" int repro_dtw(int dtype, int pcode, const void* qs, const void* cands,
                         const int64_t* qidx, const int64_t* cidx,
                         const void* bounds, int64_t npairs, int64_t bstride,
                         int n, int w, int d, void* out, void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 0) return (int)cudaGetLastError();
  if (d < 1) return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, pcode,
    cudaError_t err = dtw_dispatch<T, P>(
        static_cast<const T*>(qs), static_cast<const T*>(cands), qidx, cidx,
        nullptr, static_cast<const T*>(bounds), 0, npairs, bstride, n, w, d,
        static_cast<T*>(out), repro::MergeOut<T>{}, nullptr, static_cast<T*>(workspace), s);
    if (err != cudaSuccess) return (int)err;)
  return (int)cudaGetLastError();
}

// The masked-dense entry of the host driver's device-resident loop: slot
// s = q * nb + b runs query q against candidate row b of `cands` (nb rows)
// when stage[s] == n_lb (a survivor of K4's n_lb LB stages, 2 or 3) and
// writes out[s]; every other slot's warp skips the DP before it reads a
// row, and its out[s] is left as it was.  bounds[q * bound_stride] is
// query q's powered abandon bound, or bounds is nullptr for no abandon
// test.  The same launch then merges the block starting at database row
// lo into top_v (Q, k), top_i, counts (n_lb + 1, Q) and totals (4,) as
// repro_block_merge does (block_merge.cuh), bit for bit; `workspace` holds Q zeros (unsigned 64-bit), left so, then,
// where the long-row path keeps its diagonals there, the
// repro_dtw_workspace bytes of Q * nb pairs.  Rows of d > 1 channels
// take the channel paths, as in repro_dtw.
extern "C" int repro_dtw_masked(int dtype, int pcode, const void* qs,
                                const void* cands, const uint8_t* stage,
                                const void* bounds, int64_t bound_stride,
                                int64_t nq, int64_t nb, int n, int w, int d, void* out,
                                void* top_v, int64_t* top_i, int k, int64_t lo,
                                int dtw_chunk, int n_lb, int64_t* counts,
                                int64_t* totals, void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq * nb == 0) return (int)cudaGetLastError();
  if (stage == nullptr || (bounds != nullptr && bound_stride < 1) || top_v == nullptr ||
      top_i == nullptr || k < 1 || dtw_chunk < 1 || n_lb < 1 || n_lb > 3 ||
      counts == nullptr || totals == nullptr || workspace == nullptr || d < 1)
    return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, pcode,
    const repro::MergeOut<T> m{static_cast<T*>(top_v), top_i, counts, totals, k,
                               dtw_chunk, lo, n_lb};
    cudaError_t err = dtw_dispatch<T, P>(
        static_cast<const T*>(qs), static_cast<const T*>(cands), nullptr, nullptr,
        stage, static_cast<const T*>(bounds), bound_stride, nq * nb, nb, n, w, d,
        static_cast<T*>(out), m, static_cast<unsigned long long*>(workspace),
        reinterpret_cast<T*>(static_cast<unsigned long long*>(workspace) + nq), s);
    if (err != cudaSuccess) return (int)err;)
  return (int)cudaGetLastError();
}

// Bytes of workspace the long-row path needs for the diagonals of npairs
// pairs (0: none); the masked entry's workspace holds them after its Q
// tickets.
extern "C" int64_t repro_dtw_workspace(int dtype, int64_t npairs, int n, int w, int d) {
  return (int64_t)(dtype == 0 ? dtw_diag_bytes<float>(npairs, n, w, d)
                              : dtw_diag_bytes<double>(npairs, n, w, d));
}

// The path a launch at (n, w, d) takes: S > 0 the register path with S
// slots per lane, 0 the shared-memory path, -1 (LONG_ROWS) the long-row
// path; d > 1: -2 (CHANNELS) staged segments, -3 (CHANNELS_LONG) in place.
extern "C" int repro_dtw_slots(int dtype, int n, int w, int d) {
  return dtype == 0 ? dtw_slots<float>(n, w, d) : dtw_slots<double>(n, w, d);
}
