"""TC-DTW pruning bounds: the coarse envelope box and the triangle stage
(port of ``repro.mv.tc``), tensor code.

**tc_box** — split each channel's time axis into S coarse segments.  For
a candidate c and segment [a, b) of channel ch, with ``cmin``/``cmax``
bounding the candidate's samples and ``Umax = max U``, ``Lmin = min L``
the query envelope over the segment, every per-position envelope
distance is >= g := max(0, cmin - Umax, Lmin - cmax), so the powered
LB_Keogh sum over the segment is >= (b - a) g^p (>= g at p = inf), and
summing the segments (max at inf) gives

    tc_box <= LB_Keogh_mv <= DTW_mv     (powered domain).

**tc_tri** — Theorem 1's banded triangle bound as an in-pipeline stage
against the running top-k bound, from the reference-index context the
indexed driver threads in (``core.pipeline.TriContext``).  The constant
``min(2w+1, n)^(1/p)`` holds for dependent mv DTW with n the per-channel
length.

Both are reductions outside any kernel in the reference as well.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.dtw import PNorm, elem_cost
from repro_torch.index.triangle_lb import SLACK, powered

#: coarse segments per channel for tc_box (any segmentation is sound)
TC_BOX_SEGMENTS = 8


def box_segments(n: int, s: int = TC_BOX_SEGMENTS) -> list[tuple[int, int]]:
    """S near-equal [a, b) splits of a length-n axis (fewer when n < S)."""
    n = int(n)
    s = max(1, min(int(s), n))
    bounds = [round(i * n / s) for i in range(s + 1)]
    return [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def _tc_box_impl(cs, upper, lower, p, d, segments, outer):
    """Shared tc_box loop.  ``outer=True``: cs (B, d*n) vs envelopes
    (Q, d*n) -> (Q, B); ``outer=False``: lane-paired (chunk, d*n) arrays
    -> (chunk,).  The (channel, segment) accumulation order is the same in
    both modes, so the pair form bit-matches the dense tile."""
    n = cs.shape[-1] // d
    out = None
    for ch in range(d):
        for a, b in box_segments(n, segments):
            sl = slice(ch * n + a, ch * n + b)
            cmin = cs[..., sl].amin(dim=-1)
            cmax = cs[..., sl].amax(dim=-1)
            umax = upper[..., sl].amax(dim=-1)
            lmin = lower[..., sl].amin(dim=-1)
            if outer:
                gap_lo = lmin[..., :, None] - cmax[..., None, :]
                gap_hi = cmin[..., None, :] - umax[..., :, None]
            else:
                gap_lo = lmin - cmax
                gap_hi = cmin - umax
            g = torch.clamp(torch.maximum(gap_lo, gap_hi), min=0.0)
            seg = elem_cost(g, p)
            if p != math.inf:
                seg = seg * (b - a)
            if out is None:
                out = seg
            elif p == math.inf:
                out = torch.maximum(out, seg)
            else:
                out = out + seg
    return out


def tc_box_powered_qbatch(cs, upper, lower, p: PNorm = 1, d: int = 1,
                          segments: int = TC_BOX_SEGMENTS):
    """(B, d*n) candidates vs (Q, d*n) per-segment query envelopes ->
    (Q, B) powered box bounds."""
    return _tc_box_impl(cs, upper, lower, p, d, segments, outer=True)


def tc_box_powered_pair(c, upper, lower, p: PNorm = 1, d: int = 1,
                        segments: int = TC_BOX_SEGMENTS):
    """Lane-paired tc_box: (chunk, d*n) candidates vs per-lane gathered
    (chunk, d*n) envelopes -> (chunk,), bit-matching the dense form."""
    return _tc_box_impl(c, upper, lower, p, d, segments, outer=False)


def tc_tri_powered_qbatch(d_q_refs, d_q_refs_wide, d_ref_cols, d_ref_cols_wide, c_w,
                          p: PNorm):
    """Powered LB_tri tile: the queries' reference distances (Q, R) at band
    w / 2w against the block's gathered reference columns (R, B) ->
    (Q, B); ``c_w`` is Theorem 1's constant as a tensor."""
    side_a = d_q_refs_wide[..., :, None] / c_w - d_ref_cols
    side_b = d_ref_cols_wide / c_w - d_q_refs[..., :, None]
    lo = torch.clamp(torch.maximum(side_a, side_b), min=0.0) * SLACK
    return powered(lo.amax(dim=-2), p)


def tc_tri_powered_pair(d_q_refs, d_q_refs_wide, d_ref_lanes, d_ref_lanes_wide, c_w,
                        p: PNorm):
    """Lane-paired LB_tri: per-lane reference distances, all (chunk, R) ->
    (chunk,), bit-matching the dense tile."""
    side_a = d_q_refs_wide / c_w - d_ref_lanes
    side_b = d_ref_lanes_wide / c_w - d_q_refs
    lo = torch.clamp(torch.maximum(side_a, side_b), min=0.0) * SLACK
    return powered(lo.amax(dim=-1), p)
