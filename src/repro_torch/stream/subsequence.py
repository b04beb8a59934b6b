"""Windowed subsequence matching over the shared cascade (port of
``repro.stream.subsequence``; DESIGN.md §3.5).

The database search answers "which series is nearest to q"; the stream
workload asks "*where* in an unbounded signal does any template match".
Both are the same cascade — this module cuts hop-strided window blocks
out of a ``StreamState`` and drives them through the stage pipeline the
top-k drivers use (``repro_torch.core.pipeline.run_block_stages``):
windows are the candidate lanes, templates the query batch, and the
per-query pruning bound is a fixed powered threshold instead of a
tightening k-th best.

Stages per block (windows as lanes, templates as query rows):

  S0  envelope prefilter — slices of the *stream* envelope (maintained
      online in O(1)/sample by ``StreamState``) bound LB_Keogh(template,
      window) from below the other way around: the stream envelope over a
      window's positions contains the window's own envelope, so
      ``||q - clip(q, L_str, U_str)||_p <= LB_Keogh(q, c) <= DTW(q, c)``.
      It stays the reference's float32 numpy on the host: its summation
      order decides ``env_pruned`` at the boundary.
  S1  LB_Keogh          (one launch per block)
  S2  LB_Improved pass 2 (survivor-compacted lane pairs)
  S3  banded DTW        (survivor-compacted, early-abandoning at the
                         powered threshold)

On the device.  Without z-normalization the windows of a block are
hop-strided slices of one flat segment of ``span`` samples, which is
uploaded as it is; when the method's first LB stage is LB_Keogh, S1 is
the stream-packed kernel K7 (``lb_keogh_stream_qbatch_op``), which reads
the windows in place, and its values enter ``run_block_stages`` as the
first stage's.  The (block, n) window tile that S2 and S3 gather from is
cut from the same upload on the device.  K7's LB_Keogh is bit-equal to
K2's on the copied windows, so masks, counters and matches are those of
the tile route.  With z-normalization the windows are no longer slices
of one segment: they are normalized on the host (the reference's
float64 arithmetic) and copied as a tile, and S1 is the pipeline's own
dense stage (K2).  The distances and masks come back in one copy a
block.

Multivariate streams (``d > 1``, DESIGN.md §3.12): templates (n, d) or
(Q, n, d) are flattened channel-major to (Q, d*n) rows, z-normalized per
(template, channel) segment, and enveloped per segment (K1 with the
segments folded into its batch).  Each channel has its own
``StreamState``, pushed in lockstep; a window's lanes are the d channel
windows at one start, concatenated channel-major.  S0 runs on the
concatenated stream-envelope slices, in the reference's float32 order.
Without z-normalization the block's d channel segments are uploaded once
as a (d, span) tensor and S1 is K7's channel entry (K7c), which reads
each window's flat row out of it in place; the (block, d*n) tile is
gathered from the same upload on the device.  With z-normalization the
host builds the normalized tile and S1 is K2, as at d = 1.

A window matches template ``t`` when its powered DTW distance is
``<= threshold[t]^p``; pruning uses ``nextafter(threshold^p)`` so the
strict ``lb < bound`` compare of the shared staging keeps boundary
windows (LB == threshold) alive — the match set is exactly the naive
per-window scan's.

Trivial-match exclusion: overlapping detections of the same template are
collapsed to the best one (``greedy_suppress``: ascending-distance greedy,
a hit survives unless a better *surviving* hit of the same template lies
within ``± exclusion`` samples).  ``suppress_stream`` is the streaming
form: it additionally labels each decision *stable* once no unevaluated
window and no unstable better hit can change it, so ``StreamMatcher``
emits exactly the offline suppression's output, incrementally.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Iterable, NamedTuple

import numpy as np
import torch

from repro_torch.core.dtw import PNorm
from repro_torch.core.pipeline import lb_stage_names, make_context, run_block_stages
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.envelope.ops import envelope_op
from repro_torch.kernels.lb_keogh.ops import lb_keogh_stream_qbatch_op, stream_tile
from repro_torch.mv.layout import flatten_channels
from repro_torch.stream.state import STD_EPS


class Match(NamedTuple):
    """One detection: template id, window start position, rooted distance."""

    tid: int
    start: int
    dist: float


def num_windows(length: int, n: int, hop: int) -> int:
    """Windows of length ``n`` at starts 0, hop, 2*hop, ... fully inside
    a stream of ``length`` samples."""
    if length < n:
        return 0
    return (length - n) // hop + 1


def znorm_series(x: np.ndarray, eps: float = STD_EPS) -> np.ndarray:
    """Global z-normalization (templates), std floored at ``eps``."""
    x64 = np.asarray(x, np.float64)
    mean = x64.mean()
    std = max(float(x64.std()), eps)
    return ((x64 - mean) / std).astype(np.float32)


def znorm_windows(
    wins: np.ndarray, mean: np.ndarray, std: np.ndarray
) -> np.ndarray:
    """Per-window z-normalization with precomputed rolling stats."""
    z = (wins.astype(np.float64) - mean[:, None]) / std[:, None]
    return z.astype(np.float32)


def powered_threshold(threshold: np.ndarray, p: PNorm) -> np.ndarray:
    """Rooted per-template threshold -> float32 powered domain."""
    thr = np.asarray(threshold, np.float64)
    if p == math.inf or p == 1:
        pw = thr
    else:
        pw = thr**p
    return pw.astype(np.float32)


def envelope_prefilter(
    qs: np.ndarray, u_wins: np.ndarray, l_wins: np.ndarray, p: PNorm
) -> np.ndarray:
    """Powered LB_Keogh(template, window-envelope) — (Q, B) from (Q, n)
    templates and (B, n) per-window envelope slices.  Any elementwise
    widening of the true window envelope keeps this a valid DTW lower
    bound, so stream-envelope slices (which cover a superset of each
    window) are admissible."""
    d = np.maximum(qs[:, None, :] - u_wins[None], 0.0) + np.maximum(
        l_wins[None] - qs[:, None, :], 0.0
    )
    if p == math.inf:
        return np.max(d, axis=-1)
    if p == 1:
        return np.sum(d, axis=-1)
    if p == 2:
        return np.sum(d * d, axis=-1)
    return np.sum(d**p, axis=-1)


def finish_np(acc: np.ndarray, p: PNorm) -> np.ndarray:
    """Powered -> rooted distance (numpy twin of core.dtw.finish_cost)."""
    if p == math.inf or p == 1:
        return acc
    if p == 2:
        return np.sqrt(acc)
    return acc ** (1.0 / p)


@dataclasses.dataclass
class StreamStats:
    """Per-stage window accounting, one counter lane per template.

    ``env_pruned + stage_pruned.sum(axis=0) + full_dtw == n_windows``
    holds per template (the streaming analogue of ``SearchStats``'
    invariant); ``stage_pruned`` is (S, Q), one row per LB stage of the
    method's pipeline in cascade order, and ``lb1_pruned``/
    ``lb2_pruned`` are back-compat views (first stage / all later
    stages).  ``blocks_*`` count executions of the shared batched
    sweep.  ``env_pruned`` depends on how much of the stream had arrived
    when a block was processed (right-truncated tail envelopes are
    tighter), so it may shift between S0 and S1 across different
    chunkings — the match set never does.
    """

    n_templates: int
    stage_names: tuple[str, ...]  # LB stages of the method, cascade order
    n_windows: np.ndarray  # (Q,) windows evaluated per template
    env_pruned: np.ndarray  # (Q,) killed by the S0 stream-envelope bound
    stage_pruned: np.ndarray  # (S, Q) killed by each LB stage
    full_dtw: np.ndarray  # (Q,) windows that reached the banded DP
    matched: np.ndarray  # (Q,) raw hits below threshold (pre-exclusion)
    blocks_total: int = 0
    blocks_lb2: int = 0
    blocks_dtw: int = 0
    # DP lane economics, batch-level like blocks_* (DESIGN.md §3.6):
    # lanes the compacted DP actually executed vs alive lanes among them
    dp_lane_work: int = 0
    dp_lane_useful: int = 0

    @classmethod
    def zeros(
        cls,
        n_templates: int,
        stage_names: tuple[str, ...] = ("lb_keogh", "lb_improved"),
    ) -> "StreamStats":
        z = lambda: np.zeros(n_templates, np.int64)
        sp = np.zeros((len(stage_names), n_templates), np.int64)
        return cls(n_templates, stage_names, z(), z(), sp, z(), z())

    @property
    def lb1_pruned(self) -> np.ndarray:
        """(Q,) windows killed by the first LB stage (back-compat view)."""
        if len(self.stage_names) == 0:
            return np.zeros(self.n_templates, np.int64)
        return self.stage_pruned[0]

    @property
    def lb2_pruned(self) -> np.ndarray:
        """(Q,) windows killed by any later LB stage (back-compat view)."""
        return self.stage_pruned[1:].sum(axis=0)

    @property
    def pruned_by(self) -> dict[str, np.ndarray]:
        """Per-stage (Q,) kill counts keyed by stage name."""
        return dict(zip(self.stage_names, self.stage_pruned))

    @property
    def pruned_before_dtw(self) -> float:
        """Fraction of (template, window) lanes killed before the DP."""
        total = int(self.n_windows.sum())
        if total == 0:
            return 0.0
        return 1.0 - int(self.full_dtw.sum()) / total

    @property
    def dp_lane_efficiency(self) -> float:
        """useful / work of the DP lanes actually executed (1.0 when the
        DP never ran)."""
        if self.dp_lane_work == 0:
            return 1.0
        return self.dp_lane_useful / self.dp_lane_work


class SubsequenceScanner:
    """Block engine: windows-as-lanes sweep of the template batch.

    Owns the (optionally z-normalized) templates, their envelopes, the
    powered thresholds and the per-stage counters; ``process_block``
    pulls one hop-strided block of windows out of a ``StreamState`` and
    returns its raw sub-threshold hits.  Drivers (``StreamMatcher``
    online, ``windowed_matches`` offline) own window scheduling and
    trivial-match exclusion.  The templates, their envelopes and the
    gate live on ``device`` (default: the GPU; ``RuntimeError`` when
    there is none), where every block's stages run.  ``d > 1`` takes
    (n, d) or (Q, n, d) templates and a d-channel stream (one
    ``StreamState`` per channel).
    """

    def __init__(
        self,
        templates: np.ndarray,
        w: int,
        threshold,
        *,
        p: PNorm = 1,
        hop: int = 1,
        znorm: bool = False,
        block: int = 64,
        method: str = "lb_improved",
        prefilter: bool = True,
        eps: float = STD_EPS,
        envelopes: tuple | None = None,
        d: int = 1,
        device=None,
    ):
        self.d = int(d)
        if self.d < 1:
            raise ValueError(f"d must be >= 1 channels, got {d}")
        templates = np.asarray(templates, np.float32)
        if self.d > 1:
            # multivariate templates: (n, d) single or (Q, n, d) batch,
            # flattened channel-major to the (Q, d*n) row layout every
            # driver shares (DESIGN.md §3.12)
            if templates.ndim == 2:
                templates = templates[None]
            if templates.ndim != 3 or templates.shape[-1] != self.d:
                raise ValueError(
                    f"multivariate templates must be (n, {self.d}) or "
                    f"(Q, n, {self.d}); got shape {templates.shape}"
                )
            self.nq, self.n = templates.shape[0], templates.shape[1]
            templates = np.ascontiguousarray(flatten_channels(templates))
        else:
            templates = np.atleast_2d(templates)
            self.nq, self.n = templates.shape
        if hop <= 0:
            raise ValueError(f"hop must be positive, got {hop}")
        if block <= 0:
            raise ValueError(f"block must be positive, got {block}")
        self.device = resolve_device(device)
        self.w = int(min(w, self.n - 1))
        self.p = p
        self.hop = int(hop)
        self.znorm = bool(znorm)
        self.block = int(block)
        self.method = method
        self.stage_names = lb_stage_names(method)
        self.prefilter = bool(prefilter)
        self.eps = float(eps)
        if znorm:
            # per (template, channel): each channel segment of the
            # flattened row is its own series (a no-op reshape at d=1)
            seg = templates.reshape(self.nq * self.d, self.n)
            seg = np.stack([znorm_series(t, eps) for t in seg])
            templates = seg.reshape(self.nq, self.d * self.n)
        self.templates = templates
        thr = np.broadcast_to(
            np.asarray(threshold, np.float64), (self.nq,)
        ).astype(np.float64)
        if np.any(thr < 0):
            raise ValueError("thresholds must be >= 0")
        self.threshold = thr  # rooted, per template
        self.thr_pow = powered_threshold(thr, p)  # float32 powered
        # strict `lb < bound` in the shared staging must keep lb == thr
        self.gate = np.nextafter(self.thr_pow, np.float32(np.inf))
        dev = self.device
        qs = torch.as_tensor(templates, device=dev)
        if envelopes is None:
            upper, lower = envelope_op(qs, self.w, self.d)  # K1 on the device
        else:
            # prebuilt template envelopes (a repro_torch.api.Database build
            # artifact): must match the post-znorm templates at band w
            upper, lower = (
                torch.as_tensor(e, dtype=torch.float32, device=dev).contiguous()
                for e in envelopes
            )
            if upper.shape != qs.shape or lower.shape != qs.shape:
                raise ValueError(
                    f"prebuilt envelopes shaped {tuple(upper.shape)}/"
                    f"{tuple(lower.shape)} do not match the template bank "
                    f"{tuple(qs.shape)}"
                )
            # a valid envelope contains its series; too-tight envelopes
            # (wrong band, or built pre-znorm for a znorm scanner) would
            # silently prune true matches — refuse them here
            if not bool(((upper >= qs) & (lower <= qs)).all()):
                raise ValueError(
                    "prebuilt envelopes do not contain the (post-znorm) "
                    "templates — they were built at a different band or "
                    "normalization and would make the LB cascade unsound"
                )
        self._qs, self._upper, self._lower = qs, upper, lower
        self._ctx = make_context(qs, upper, lower, self.w, p, method, d=self.d)
        self._gate = torch.as_tensor(self.gate, device=dev)
        # S1 by K7 over the block's segment (K7c at d > 1): windows that
        # are slices of the raw stream, and LB_Keogh as the first LB stage
        self.stream_first = not self.znorm and self.stage_names[:1] == ("lb_keogh",)
        self.stats = StreamStats.zeros(self.nq, self.stage_names)

    @property
    def span(self) -> int:
        """Samples covered by one full block of windows."""
        return (self.block - 1) * self.hop + self.n

    def process_block(
        self, state, start0: int, n_valid: int
    ) -> list[Match]:
        """Evaluate windows starting at ``start0 + hop*i`` for
        ``i < n_valid`` (the rest of the block is masked padding).
        Returns raw sub-threshold hits, exclusion not yet applied.

        ``state`` is one :class:`StreamState` for univariate scanners
        and a sequence of ``d`` channel states (pushed in lockstep) for
        multivariate ones.
        """
        if n_valid <= 0:
            return []
        n, hop, block, d = self.n, self.hop, self.block, self.d
        states = [state] if d == 1 else list(state)
        if len(states) != d:
            raise ValueError(
                f"multivariate scanner needs {d} channel states, "
                f"got {len(states)}"
            )
        starts = start0 + hop * np.arange(block, dtype=np.int64)
        valid = np.arange(block) < n_valid
        avail = starts[n_valid - 1] + n - start0  # samples really present
        seg, wins, mask0 = self._window_lanes(states, start0, avail, starts, valid)

        dev = self.device
        first = None
        if wins is None:
            # the (d, span) segment, once: K7 (K7c at d > 1) reads its
            # windows in place, and the tile the compacted stages gather
            # from is cut from it on the device
            seg_t = torch.from_numpy(seg).to(dev)
            blk = stream_tile(seg_t, n, hop, d).contiguous()
            if self.stream_first:
                first = lb_keogh_stream_qbatch_op(
                    seg_t, self._upper, self._lower, n, hop, self.p, d=d
                )[0]
        else:
            blk = torch.from_numpy(wins).to(dev)
        res = run_block_stages(
            self._qs, self._upper, self._lower, self.w, self.p, self.method,
            blk, self._gate, torch.from_numpy(mask0).to(dev), d=d, ctx=self._ctx,
            first=first,
        )
        # the distances and every mask back in one copy
        lanes = self.nq * block
        packed = torch.cat(
            [res.d.reshape(-1)] + [m.reshape(-1).to(res.d.dtype) for m in res.masks]
        ).cpu().numpy()
        dist = packed[:lanes].reshape(self.nq, block)
        masks = packed[lanes:].reshape(len(res.masks), self.nq, block) != 0

        st = self.stats
        st.n_windows += n_valid
        for s in range(len(st.stage_names)):
            st.stage_pruned[s] += (masks[s] & ~masks[s + 1]).sum(axis=1)
        st.full_dtw += masks[-1].sum(axis=1)
        st.blocks_total += 1
        st.blocks_lb2 += int(res.need_lb2)
        st.blocks_dtw += int(res.need_dtw)
        st.dp_lane_work += int(res.dp_lane_work)
        st.dp_lane_useful += int(res.dp_lane_useful)

        hit = dist <= self.thr_pow[:, None]
        st.matched += hit.sum(axis=1)
        rooted = finish_np(dist.astype(np.float64), self.p)
        out = []
        for qi, bi in zip(*np.nonzero(hit)):
            out.append(Match(int(qi), int(starts[bi]), float(rooted[qi, bi])))
        return out

    def _window_lanes(self, states, start0, avail, starts, valid):
        """The block's lanes and S0 mask from the ``d`` channel states:
        ``(segment, None, mask0)`` with the (d, span) channel segments when
        windows are raw slices of them, else ``(None, windows, mask0)``
        with the (block, d*n) z-normalized tile (channel-major lanes).

        Each channel's windows, rolling z-norm stats and stream-envelope
        slices are cut as in the univariate scanner, then concatenated in
        channel order, the layout the templates were flattened to.  S0
        stays sound channel-wise: each channel's stream envelope contains
        the window's own channel envelope, and ``envelope_prefilter`` on
        the concatenated rows is the channel-summed (p < inf) /
        channel-maxed (p = inf) LB_Keogh, in the reference's float32
        order.
        """
        n, hop, block = self.n, self.hop, self.block
        sw = np.lib.stride_tricks.sliding_window_view
        pad = max(self.span - avail, 0)  # tail block: pad so strides stay static

        def padded(x):
            return np.concatenate([x, np.zeros(pad, x.dtype)]) if pad else x

        segs = [padded(st.view(start0, avail)) for st in states]
        wins = None
        if self.znorm:
            valid_starts = np.where(valid, starts, starts[0])
            ch_stats = [st.window_mean_std(valid_starts, n, self.eps) for st in states]
            wins = np.concatenate(
                [znorm_windows(sw(seg, n)[::hop][:block], mean, std)
                 for seg, (mean, std) in zip(segs, ch_stats)],
                axis=1,
            )

        mask0 = np.broadcast_to(valid[None, :], (self.nq, block)).copy()
        if self.prefilter:
            u_parts, l_parts = [], []
            for ci, st in enumerate(states):
                u_seg, l_seg = st.envelope_view(start0, avail)
                u_w = sw(padded(u_seg), n)[::hop][:block]
                l_w = sw(padded(l_seg), n)[::hop][:block]
                if self.znorm:
                    mean, std = ch_stats[ci]
                    u_w = ((u_w - mean[:, None]) / std[:, None]).astype(
                        np.float32
                    )
                    l_w = ((l_w - mean[:, None]) / std[:, None]).astype(
                        np.float32
                    )
                u_parts.append(u_w)
                l_parts.append(l_w)
            u_all = np.concatenate(u_parts, axis=1)
            l_all = np.concatenate(l_parts, axis=1)
            lb0 = envelope_prefilter(self.templates, u_all, l_all, self.p)
            alive0 = mask0 & (lb0 < self.gate[:, None])
            self.stats.env_pruned += (mask0 & ~alive0).sum(axis=1)
            mask0 = alive0
        return (None if self.znorm else np.stack(segs)), wins, mask0


# ------------------------------------------------- trivial-match exclusion


def _order(hits: Iterable[Match]) -> list[Match]:
    return sorted(hits, key=lambda h: (h.dist, h.start, h.tid))


def greedy_suppress(hits: Iterable[Match], exclusion: int) -> list[Match]:
    """Offline trivial-match exclusion: ascending-distance greedy.  A hit
    survives unless a better *surviving* hit of the same template starts
    within ``exclusion`` samples (ties broken by start, then template
    id).  Returned in stream order."""
    kept: list[Match] = []
    kept_by_tid: dict[int, list[int]] = defaultdict(list)
    for h in _order(hits):
        if all(abs(h.start - s) >= exclusion for s in kept_by_tid[h.tid]):
            kept.append(h)
            kept_by_tid[h.tid].append(h.start)
    return sorted(kept, key=lambda h: (h.start, h.tid))


@dataclasses.dataclass
class _Decision:
    hit: Match
    accepted: bool
    stable: bool


def suppress_stream(
    hits: Iterable[Match], frontier: float, exclusion: int
) -> tuple[list[Match], list[Match], list[Match]]:
    """Streaming trivial-match exclusion with stability labelling.

    Runs the same ascending-distance greedy as ``greedy_suppress`` over
    the hits seen so far, then labels a decision *stable* when nothing
    that arrives later can change it: every window start within
    ``exclusion`` of the hit has been evaluated (``frontier`` is the
    next unevaluated start, ``inf`` after a flush) **and** every better
    hit inside its exclusion zone — accepted or not — is itself stable.
    The second condition resolves suppression chains (a better hit that
    might itself be un-suppressed by a still-better future hit would
    flip this one), so emitted decisions provably equal the offline
    greedy over the complete hit set.

    Returns ``(stable_accepted, stable_suppressed, pending)``.
    """
    decisions: list[_Decision] = []
    by_tid: dict[int, list[_Decision]] = defaultdict(list)
    for h in _order(hits):
        zone = [
            e
            for e in by_tid[h.tid]
            if abs(e.hit.start - h.start) < exclusion
        ]
        accepted = not any(e.accepted for e in zone)
        stable = frontier >= h.start + exclusion and all(
            e.stable for e in zone
        )
        e = _Decision(h, accepted, stable)
        decisions.append(e)
        by_tid[h.tid].append(e)
    acc = [e.hit for e in decisions if e.stable and e.accepted]
    rej = [e.hit for e in decisions if e.stable and not e.accepted]
    pend = [e.hit for e in decisions if not e.stable]
    key = lambda h: (h.start, h.tid)
    return sorted(acc, key=key), sorted(rej, key=key), sorted(pend, key=key)
