"""StreamMatcher: push-samples / poll-matches service (port of
``repro.stream.matcher``; DESIGN.md §3.5).

The serving shape of the stream subsystem: a caller owns an unbounded
signal and wants every subsequence matching any of its templates, as
the samples arrive.

    matcher = StreamMatcher(templates, w=12, threshold=3.0, hop=2)
    for chunk in signal_source:
        matcher.push(chunk)
        for m in matcher.poll():          # finalized Match tuples
            alarm(m.tid, m.start, m.dist)
    matcher.flush()
    tail = matcher.poll()

``push`` ingests samples into the ring-buffered ``StreamState`` (on the
host) and sweeps every window block that became complete through the
shared cascade on the session's device (one batched sweep per block
serves all templates).  ``poll`` returns matches whose trivial-match-
exclusion decision is *stable* — provably equal to what an offline scan
of the whole stream would emit (``subsequence.suppress_stream``).
``flush`` evaluates the final partial block and finalizes every pending
decision.

``windowed_matches`` is the offline driver: one call over an in-memory
array, same engine, used as the replay twin of a streamed run (matches
are bit-identical; only the S0 ``env_pruned`` stats may shift, since a
live stream prunes with right-truncated tail envelopes — see
``StreamStats``).

Both run on ``device`` (default: the GPU; ``RuntimeError`` when there is
none, never a quiet run on the CPU).
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.dtw import PNorm
from repro_torch.stream.state import STD_EPS, StreamState
from repro_torch.stream.subsequence import (
    Match,
    StreamStats,
    SubsequenceScanner,
    num_windows,
    suppress_stream,
)


class StreamMatcher:
    """Online subsequence matcher over the LB cascade.

    Parameters mirror ``SubsequenceScanner`` plus:

    * ``exclusion`` — trivial-match radius in samples: of two same-
      template hits closer than this, only the better survives.
      Defaults to the template length (overlapping detections collapse
      to the best one).
    * ``capacity`` — ring size.  Defaults to twice the block span;
      larger values let ``push`` accept bigger chunks in one bite, but
      any chunk size works (oversized pushes are ingested in ring-sized
      bites with block sweeps interleaved, so no unevaluated window's
      samples are ever evicted).
    * ``d`` — channel count.  ``d > 1`` takes (n, d) / (Q, n, d)
      templates and a d-channel stream: ``push`` accepts (m, d) sample
      chunks (or flat sample-major interleaved arrays whose size
      divides by d); one ring per channel advances in lockstep, and
      windows run through the dependent-DTW cascade (DESIGN.md §3.12).
    * ``device`` — where the templates live and the blocks run.
    """

    def __init__(
        self,
        templates,
        w: int,
        threshold,
        *,
        p: PNorm = 1,
        hop: int = 1,
        znorm: bool = False,
        block: int = 64,
        method: str = "lb_improved",
        prefilter: bool = True,
        exclusion: int | None = None,
        capacity: int | None = None,
        eps: float = STD_EPS,
        envelopes: tuple | None = None,
        d: int = 1,
        device=None,
    ):
        self.d = int(d)
        self.scanner = SubsequenceScanner(
            templates,
            w,
            threshold,
            p=p,
            hop=hop,
            znorm=znorm,
            block=block,
            method=method,
            prefilter=prefilter,
            eps=eps,
            envelopes=envelopes,
            d=d,
            device=device,
        )
        self.exclusion = (
            int(exclusion) if exclusion is not None else self.scanner.n
        )
        if self.exclusion < 1:
            raise ValueError(f"exclusion must be >= 1, got {self.exclusion}")
        span = self.scanner.span
        cap = 2 * span if capacity is None else int(capacity)
        if cap <= span:
            raise ValueError(
                f"capacity {cap} must exceed the block span {span}"
            )
        # one ring per channel, pushed in lockstep; `state` stays the
        # canonical position axis (and the only ring at d = 1)
        self.states = [
            StreamState(cap, self.scanner.w) for _ in range(self.d)
        ]
        self.state = self.states[0]
        self._next_start = 0  # next window start not yet evaluated
        # the resolve pool stays small on an unbounded stream: a stable
        # accepted hit retires to _archive once nothing pending or
        # future can reach its exclusion zone, so per-poll suppression
        # cost tracks the live window, not the stream history
        self._pending: list[Match] = []  # raw hits, exclusion unresolved
        self._live_acc: list[Match] = []  # stable accepted, still in pool
        self._archive: list[Match] = []  # retired accepted, final forever
        self._emitted: set[tuple[int, int]] = set()  # pool hits emitted
        self._out: list[Match] = []  # finalized, not yet polled
        self._flushed = False

    # ------------------------------------------------------------ intake

    @property
    def device(self):
        return self.scanner.device

    @property
    def samples_seen(self) -> int:
        return self.state.count

    @property
    def windows_evaluated(self) -> int:
        return self._next_start // self.scanner.hop

    @property
    def stats(self) -> StreamStats:
        return self.scanner.stats

    def push(self, samples) -> None:
        """Ingest samples; sweeps every window block that completed.

        At ``d > 1`` samples arrive as an (m, d) chunk — or a flat
        sample-major interleaved array whose size divides by d — and
        each column feeds its channel's ring, keeping all rings at the
        same position count.
        """
        if self._flushed:
            raise RuntimeError("push after flush: the stream is closed")
        bite = self.state.capacity - self.scanner.span
        if self.d == 1:
            arr = np.asarray(samples).ravel()
            for lo in range(0, arr.size, bite):
                self.state.push(arr[lo : lo + bite])
                self._sweep_full_blocks()
            return
        arr = np.asarray(samples)
        if arr.ndim == 1:
            if arr.size % self.d:
                raise ValueError(
                    f"flat push of {arr.size} samples does not divide by "
                    f"d={self.d} channels; push (m, {self.d}) chunks"
                )
            arr = arr.reshape(-1, self.d)
        if arr.ndim != 2 or arr.shape[1] != self.d:
            raise ValueError(
                f"multivariate push expects (m, {self.d}) samples, got "
                f"shape {np.asarray(samples).shape}"
            )
        for lo in range(0, arr.shape[0], bite):
            chunk = arr[lo : lo + bite]
            for st, col in zip(self.states, chunk.T):
                st.push(col)
            self._sweep_full_blocks()

    def _sweep_full_blocks(self) -> None:
        sc = self.scanner
        src = self.state if self.d == 1 else self.states
        while self.state.count >= self._next_start + sc.span:
            self._pending.extend(
                sc.process_block(src, self._next_start, sc.block)
            )
            self._next_start += sc.block * sc.hop

    def flush(self) -> None:
        """Evaluate the remaining partial block (windows that fit in the
        samples seen so far) and finalize every pending decision."""
        if self._flushed:
            return
        sc = self.scanner
        src = self.state if self.d == 1 else self.states
        total = num_windows(self.state.count, sc.n, sc.hop)
        left = max(0, total - self._next_start // sc.hop)
        # the tail may still hold more than one (partial) block
        while left > 0:
            n_valid = min(left, sc.block)
            self._pending.extend(
                sc.process_block(src, self._next_start, n_valid)
            )
            self._next_start += n_valid * sc.hop
            left -= n_valid
        self._flushed = True

    # ----------------------------------------------------------- results

    @property
    def _frontier(self) -> float:
        return math.inf if self._flushed else self._next_start

    def _resolve(self) -> None:
        acc, _rej, pend = suppress_stream(
            self._live_acc + self._pending, self._frontier, self.exclusion
        )
        # pool hits re-decide identically (their zones are stable), so
        # `acc` is a superset of `_live_acc`; first-time acceptances
        # queue for poll()
        for h in acc:
            key = (h.tid, h.start)
            if key not in self._emitted:
                self._emitted.add(key)
                self._out.append(h)
        # retire accepted hits nothing can touch anymore: future hits
        # start at >= frontier (outside the zone once start + exclusion
        # <= frontier) and accepted hits of one template are mutually
        # >= exclusion apart, so only a pending hit in the zone blocks
        # retirement.  Retired hits leave the pool — and _emitted — for
        # good, keeping both O(live window) on an unbounded stream.
        live: list[Match] = []
        for h in acc:
            if h.start + self.exclusion <= self._frontier and not any(
                p.tid == h.tid and abs(p.start - h.start) < self.exclusion
                for p in pend
            ):
                self._archive.append(h)
                self._emitted.discard((h.tid, h.start))
            else:
                live.append(h)
        self._live_acc = live
        self._pending = pend

    def feed(self, samples) -> list[Match]:
        """``push`` + ``poll`` in one call: the chunk-at-a-time serving
        step (``repro_torch.serve.StreamSession`` drives the matcher this
        way).  Returns the matches the chunk finalized."""
        self.push(samples)
        return self.poll()

    def poll(self) -> list[Match]:
        """Newly finalized matches since the last poll, in stream order.
        (A late-resolving suppression chain can finalize a hit that
        *starts* before an already-polled one, so order across polls is
        near-sorted, not strictly sorted.)"""
        self._resolve()
        fresh, self._out = self._out, []
        return sorted(fresh, key=lambda h: (h.start, h.tid))

    def matches(self) -> list[Match]:
        """All finalized matches so far (after ``flush``: the complete,
        offline-equal match set)."""
        self._resolve()
        self._out = []
        return sorted(
            self._archive + self._live_acc, key=lambda h: (h.start, h.tid)
        )


def windowed_matches(
    stream,
    templates,
    w: int,
    threshold,
    *,
    p: PNorm = 1,
    hop: int = 1,
    znorm: bool = False,
    block: int = 64,
    method: str = "lb_improved",
    prefilter: bool = True,
    exclusion: int | None = None,
    eps: float = STD_EPS,
    d: int = 1,
    device=None,
) -> tuple[list[Match], StreamStats]:
    """Offline windowed scan of an in-memory stream: every hop-strided
    window through the cascade, trivial-match exclusion applied.
    Returns ``(matches, stats)``; the match set equals a chunked
    ``StreamMatcher`` run over the same array bit for bit.  At ``d > 1``
    the stream is (m, d) samples and templates are (n, d) / (Q, n, d)."""
    d = int(d)
    if d > 1:
        stream = np.asarray(stream, np.float32)
        if stream.ndim == 1:
            stream = stream.reshape(-1, d)
        n_samples = stream.shape[0]
        t = np.asarray(templates)
        n = t.shape[-2] if t.ndim >= 2 else t.shape[0]
    else:
        stream = np.asarray(stream, np.float32).ravel()
        n_samples = stream.size
        n = np.atleast_2d(np.asarray(templates)).shape[1]
    span = (block - 1) * hop + n
    m = StreamMatcher(
        templates,
        w,
        threshold,
        p=p,
        hop=hop,
        znorm=znorm,
        block=block,
        method=method,
        prefilter=prefilter,
        exclusion=exclusion,
        capacity=max(n_samples + 1, 2 * span),
        eps=eps,
        d=d,
        device=device,
    )
    m.push(stream)
    m.flush()
    return m.matches(), m.stats
