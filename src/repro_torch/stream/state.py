"""Ring-buffered stream state with truly online envelopes (port of
``repro.stream.state``; DESIGN.md §3.5).

The stream's host-side state stays in numpy, as the reference keeps it
on the host: the paper's Algorithm 1 maintains the sliding max/min of an
unbounded signal in O(1) amortized comparisons per arriving sample,
which is exactly what a subsequence matcher needs — the envelope of
position ``i`` is final the moment sample ``i + w`` arrives, long before
the window blocks that read it are formed.  The code is the reference's
own, line for line, so every push chunking gives the reference's bits.

``StreamState`` owns three aligned rings over absolute stream positions:

* raw samples;
* the finalized envelope ``U/L`` (centered window ``[i-w, i+w]``),
  produced by two monotonic deques — max-deque values strictly
  decreasing, min-deque strictly increasing, each sample pushed and
  popped at most once (<= 3n comparisons, the paper's bound);
  right-truncated tail positions (within ``w`` of the frontier) are
  computed on demand and never stored, since a later push would extend
  their window;
* float64 running prefix sums ``sum x`` / ``sum x^2``, so any window's
  mean/variance is two ring lookups (O(1) per window) — the rolling
  statistics behind optional per-window z-normalization.

Subnormal floats are kept: max and min compare them exactly, so the
online envelope equals the batch envelope (the envelope kernel K1 and
its plain version) bit for bit on rows that hold them (ROADMAP.md queue
3, C).

``prefix_sums`` / ``window_mean_std_from_prefix`` are the offline
counterparts used by tests and oracles; they perform bit-identical
arithmetic (sequential float64 accumulation) so a streamed match and
its offline replay z-normalize windows to exactly the same values.
"""

from __future__ import annotations

import collections

import numpy as np

#: std floor for z-normalization: flat windows normalize to 0, not inf
STD_EPS = 1e-8


def prefix_sums(x) -> tuple[np.ndarray, np.ndarray]:
    """Inclusive float64 prefix sums of ``x`` and ``x**2`` (offline twin
    of the running totals ``StreamState`` maintains online; numpy's
    ``cumsum`` accumulates sequentially, so the two are bit-identical)."""
    x64 = np.asarray(x, np.float64)
    return np.cumsum(x64), np.cumsum(x64 * x64)


def window_mean_std_from_prefix(
    c1: np.ndarray,
    c2: np.ndarray,
    starts: np.ndarray,
    n: int,
    eps: float = STD_EPS,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-window mean/std from inclusive prefix sums, std floored at
    ``eps``.  ``starts`` are window start positions; windows are
    ``[s, s + n)``."""
    starts = np.asarray(starts, np.int64)
    hi1 = c1[starts + n - 1]
    hi2 = c2[starts + n - 1]
    lo1 = np.where(starts > 0, c1[np.maximum(starts - 1, 0)], 0.0)
    lo2 = np.where(starts > 0, c2[np.maximum(starts - 1, 0)], 0.0)
    mean = (hi1 - lo1) / n
    var = np.maximum((hi2 - lo2) / n - mean * mean, 0.0)
    return mean, np.maximum(np.sqrt(var), eps)


class StreamState:
    """Ring buffer + online envelope + rolling window statistics.

    ``capacity`` bounds how far back samples (and their envelope /
    prefix-sum entries) stay addressable; positions older than
    ``count - capacity`` are gone.  ``w`` is the envelope half-window
    and is fixed at construction (it is a property of the matcher's
    templates, not of the stream).
    """

    def __init__(self, capacity: int, w: int, dtype=np.float32):
        if capacity < 2 * w + 2:
            raise ValueError(
                f"capacity {capacity} too small for envelope window w={w}"
            )
        if w < 0:
            raise ValueError(f"w must be >= 0, got {w}")
        self.capacity = int(capacity)
        self.w = int(w)
        self.dtype = np.dtype(dtype)
        self.count = 0  # total samples ever pushed
        self._x = np.zeros(self.capacity, self.dtype)
        self._u = np.zeros(self.capacity, self.dtype)
        self._l = np.zeros(self.capacity, self.dtype)
        self._c1 = np.zeros(self.capacity, np.float64)
        self._c2 = np.zeros(self.capacity, np.float64)
        self._t1 = 0.0
        self._t2 = 0.0
        # monotonic deques of (position, value) over the trailing window
        # [t - 2w, t]: max-deque values strictly decreasing, min-deque
        # strictly increasing (Lemire's Algorithm 1)
        self._maxq: collections.deque = collections.deque()
        self._minq: collections.deque = collections.deque()

    @property
    def oldest(self) -> int:
        """Oldest absolute position still addressable."""
        return max(0, self.count - self.capacity)

    def push(self, samples) -> None:
        """Ingest samples; O(1) amortized deque + ring work per sample."""
        arr = np.asarray(samples, self.dtype).ravel()
        cap, w = self.capacity, self.w
        win_lo = 2 * w  # trailing window is [t - 2w, t]
        for v in arr:
            t = self.count
            slot = t % cap
            self._x[slot] = v
            fv = float(v)
            self._t1 += fv
            self._t2 += fv * fv
            self._c1[slot] = self._t1
            self._c2[slot] = self._t2
            maxq, minq = self._maxq, self._minq
            while maxq and maxq[-1][1] <= v:
                maxq.pop()
            maxq.append((t, v))
            while minq and minq[-1][1] >= v:
                minq.pop()
            minq.append((t, v))
            if maxq[0][0] < t - win_lo:
                maxq.popleft()
            if minq[0][0] < t - win_lo:
                minq.popleft()
            self.count = t + 1
            if t >= w:
                # position i = t - w is final: its centered window
                # [i-w, i+w] == the trailing window [t-2w, t]
                i = t - w
                self._u[i % cap] = maxq[0][1]
                self._l[i % cap] = minq[0][1]

    # ------------------------------------------------------------- views

    def _check_range(self, start: int, length: int) -> None:
        if length < 0:
            raise ValueError(f"negative length {length}")
        if start < self.oldest:
            raise ValueError(
                f"position {start} evicted (oldest retained {self.oldest})"
            )
        if start + length > self.count:
            raise ValueError(
                f"positions [{start}, {start + length}) not yet pushed "
                f"(count={self.count})"
            )

    def view(self, start: int, length: int) -> np.ndarray:
        """Contiguous copy of samples at absolute positions
        ``[start, start + length)``."""
        self._check_range(start, length)
        idx = np.arange(start, start + length) % self.capacity
        return self._x[idx].copy()

    def envelope_view(
        self, start: int, length: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """(U, L) of the stream at positions ``[start, start + length)``.

        Positions at least ``w`` behind the frontier come from the
        finalized rings; the right-truncated tail (window clipped at
        ``count - 1``) is computed on demand from the sample ring.  Tail
        values are *tighter* than the envelope a longer stream would
        give (fewer samples inside the clipped window), so any pruning
        bound built from them stays sound — DESIGN.md §3.5.
        """
        self._check_range(start, length)
        w, cap, cnt = self.w, self.capacity, self.count
        stop = start + length
        done = min(stop, max(cnt - w, 0))  # finalized prefix [start, done)
        u = np.empty(length, self.dtype)
        l = np.empty(length, self.dtype)
        if done > start:
            idx = np.arange(start, done) % cap
            u[: done - start] = self._u[idx]
            l[: done - start] = self._l[idx]
        if stop > done:
            tail0 = max(done, start)
            seg_lo = max(self.oldest, tail0 - w)
            seg = self.view(seg_lo, cnt - seg_lo)
            for i in range(tail0, stop):
                window = seg[max(i - w, seg_lo) - seg_lo :]
                u[i - start] = window.max()
                l[i - start] = window.min()
        return u, l

    def window_mean_std(
        self, starts, n: int, eps: float = STD_EPS
    ) -> tuple[np.ndarray, np.ndarray]:
        """Rolling mean/std of windows ``[s, s + n)`` via the prefix-sum
        rings — O(1) per window, bit-identical to
        ``window_mean_std_from_prefix`` over the full stream."""
        starts = np.asarray(starts, np.int64)
        if starts.size:
            self._check_range(int(starts.min()) - (1 if starts.min() > 0 else 0), 0)
            self._check_range(int(starts.max()), n)
        cap = self.capacity
        hi1 = self._c1[(starts + n - 1) % cap]
        hi2 = self._c2[(starts + n - 1) % cap]
        lo1 = np.where(starts > 0, self._c1[(starts - 1) % cap], 0.0)
        lo2 = np.where(starts > 0, self._c2[(starts - 1) % cap], 0.0)
        mean = (hi1 - lo1) / n
        var = np.maximum((hi2 - lo2) / n - mean * mean, 0.0)
        return mean, np.maximum(np.sqrt(var), eps)
