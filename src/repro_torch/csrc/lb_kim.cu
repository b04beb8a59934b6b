// K6: query-major LB_Kim with an entry mask (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel repro/kernels/lb_kim/kernel.py:
// lb_kim_qbatch_pallas (_lb_kim_qbatch_kernel).
//
// For each (query q, candidate c) pair, from the four features first,
// last, max and min of each row, the powered LB_Kim of kim.cuh
// (kim_bound); lanes whose entry mask is 0 get BIG (1e30), so they stay
// dead downstream.
//
// Bound on this card: bytes.  The work needs each candidate and query row
// read once, (Q + B) n values, and one value written per pair; the
// features make the pairs O(1) each.  Design: two phases in one launch.
// Phase 1 gives each row one warp (`warps` rows per block, the tune knob
// tile_b; it changes no result): candidates first, then queries, spread
// over (B + Q) / warps blocks, each row reduced to its features by
// row_extrema (16-byte loads where the row is aligned, all of a lane's
// loads in flight at once) into the caller's workspace.  Phase 2 runs in
// the last block to finish phase 1: each block takes a ticket once its
// features are written (lane 0 of each warp fences its stores, then
// thread 0 adds 1 to the ticket with acquire and release semantics, the
// pattern of K5's merge epilogue), and the block that takes the last
// ticket resets it, stages the queries' features in shared memory and
// writes every (q, c) lane, a thread per candidate and query group, the
// candidate's features read once through L2.  So the op is one launch with
// no host synchronisation, and reads each row once instead of once per
// pair.  repro_lb_kim_features runs phase 1 alone: the query features of
// K4's kim entry.
#include "kim.cuh"

namespace repro {

// Queries whose features the last block holds in shared memory at a time.
constexpr int KIM_QTILE = 128;

// Rows r < nb are cands[r], rows nb <= r < nb + nq are qs[r - nb]; the
// features of row r go to feats[4 r .. 4 r + 3].  With a ticket (one
// zeroed counter, left at 0), the last block then writes lb (Q, B).
template <typename T, int P>
__global__ void lb_kim_kernel(const T* __restrict__ cands, const T* __restrict__ qs,
                              const uint8_t* __restrict__ mask, int64_t nq, int64_t nb,
                              int n, T* feats, unsigned long long* ticket,
                              T* __restrict__ lb) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r < nb + nq) {  // no return: every thread reaches the barriers below
    const T* row = r < nb ? cands + r * n : qs + (r - nb) * n;
    T mx, mn;
    row_extrema(row, n, lane, mx, mn);
    if (lane == 0) {
      T* f = feats + 4 * r;
      f[KIM_FIRST] = row[0];
      f[KIM_LAST] = row[n - 1];
      f[KIM_MAX] = mx;
      f[KIM_MIN] = mn;
      if (ticket) __threadfence();  // the features before the block's ticket
    }
  }
  if (!ticket) return;
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long old;
    asm volatile("atom.add.acq_rel.gpu.u64 %0, [%1], %2;"
                 : "=l"(old) : "l"(ticket), "l"(1ull) : "memory");
    last = old == (unsigned long long)(gridDim.x - 1);
    if (last) *ticket = 0;  // every block has taken its ticket
  }
  __syncthreads();
  if (!last) return;
  // phase 2: candidate c on `cols` threads' columns, the queries of a tile
  // split over `groups` rows of threads
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int cols = nb < nthreads ? (int)nb : nthreads;
  const int groups = nthreads / cols;
  const int g = tid / cols, c0 = tid % cols;
  __shared__ T qf[4 * KIM_QTILE];
  for (int64_t q0 = 0; q0 < nq; q0 += KIM_QTILE) {
    const int qn = (int)(nq - q0 < KIM_QTILE ? nq - q0 : KIM_QTILE);
    for (int i = tid; i < 4 * qn; i += nthreads) qf[i] = __ldcg(feats + 4 * (nb + q0) + i);
    __syncthreads();
    if (g < groups) {
      for (int64_t c = c0; c < nb; c += cols) {
        const T* cf = feats + 4 * c;
        const T cfirst = __ldcg(cf + KIM_FIRST), clast = __ldcg(cf + KIM_LAST);
        const T cmax = __ldcg(cf + KIM_MAX), cmin = __ldcg(cf + KIM_MIN);
        for (int j = g; j < qn; j += groups) {
          const int64_t pair = (q0 + j) * nb + c;
          lb[pair] = mask && !mask[pair]
                         ? big<T>()
                         : kim_bound<T, P>(cfirst, clast, cmax, cmin, qf + 4 * j);
        }
      }
    }
    __syncthreads();  // qf is rewritten for the next tile
  }
}

}  // namespace repro

// cands (B, n); qs (Q, n); mask (Q, B) bytes or nullptr (all live); feats
// 4 (B + Q) values of workspace; ticket one unsigned 64-bit zero, left so;
// lb (Q, B).  warps 1..32 rows per block.
extern "C" int repro_lb_kim(int dtype, int pcode, const void* cands, const void* qs,
                            const uint8_t* mask, int64_t nq, int64_t nb, int n, int warps,
                            void* feats, void* ticket, void* lb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq * nb == 0) return (int)cudaGetLastError();
  if (warps < 1 || warps > 32 || n < 1 || feats == nullptr || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((nq + nb + warps - 1) / warps);
  REPRO_DISPATCH(dtype, pcode,
    repro::lb_kim_kernel<T, P><<<blocks, 32 * warps, 0, s>>>(
        static_cast<const T*>(cands), static_cast<const T*>(qs), mask, nq, nb, n,
        static_cast<T*>(feats), static_cast<unsigned long long*>(ticket),
        static_cast<T*>(lb)));
  return (int)cudaGetLastError();
}

// rows (R, n) -> feats (R, 4): (first, last, max, min) of each row, K6's
// phase 1 alone.  warps 1..32 rows per block.
extern "C" int repro_lb_kim_features(int dtype, const void* rows, int64_t nrows, int n,
                                     int warps, void* feats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrows == 0) return (int)cudaGetLastError();
  if (warps < 1 || warps > 32 || n < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((nrows + warps - 1) / warps);
  switch (dtype) {
    case 0:
      repro::lb_kim_kernel<float, 1><<<blocks, 32 * warps, 0, s>>>(
          static_cast<const float*>(rows), nullptr, nullptr, 0, nrows, n,
          static_cast<float*>(feats), nullptr, nullptr);
      break;
    case 1:
      repro::lb_kim_kernel<double, 1><<<blocks, 32 * warps, 0, s>>>(
          static_cast<const double*>(rows), nullptr, nullptr, 0, nrows, n,
          static_cast<double*>(feats), nullptr, nullptr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
