"""Composable cascade stage pipeline with survivor compaction.

Port of ``repro.core.pipeline``.  Every bound is declared once as a
:class:`Stage` (a dense ``(Q, B)`` form and a compacted per-lane-pair
form) and listed in :data:`PIPELINES` per cascade method; the scan,
host and indexed drivers consume the registry.

On CUDA tensors the stages launch the hand-written kernels: LB_Kim (K6),
LB_Keogh and its projection (K2), LB_Improved pass 2 (K3), the banded DP
(K5) and the envelopes the stages need (K1).  LB_Webb has no kernel: like
the reference, which runs it as jnp code outside any kernel, it runs as
``core.lb`` tensor code on the device (its envelopes come from K1), as
does the per-pair LB_Kim form (LB_Kim is always a first, dense stage).
On CPU tensors every stage runs the plain PyTorch versions.

Rows may be multivariate: ``PipeContext.d`` channels in the
channel-major flattened layout (``repro_torch.mv.layout``).  The
envelopes are then per channel segment (K1 over the segment view),
LB_Kim and LB_Keogh run verbatim on the flat rows, LB_Improved's pass 2
folds the channels into K3's rows, and the DP runs K5's channel entry.
The TC-DTW stages ``tc_box`` and ``tc_tri`` (``repro_torch.mv.tc``) are
tensor code, as in the reference; ``tc_tri`` reads the reference-index
context (:class:`TriContext`) that the indexed driver threads in, and
without it is the zero bound, which prunes nothing.  At d = 1 every
stage is the univariate one.

After each LB stage the alive ``(query, candidate)`` lane pairs are
compacted with a stable alive-first sort and processed in
``lane_chunk``-sized gathers; past half the lanes the dense tile form
runs instead.  The compacted DP threads each lane's powered bound into
the kernel's early abandon (finite p); abandoned lanes return a value
>= bound, which can never enter a top-k whose k-th best is that bound.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Literal, NamedTuple

import torch

from repro_torch.core import lb as lb_mod
from repro_torch.core.dtw import BIG, PNorm
from repro_torch.kernels.dtw.ops import dtw_pairs_op, dtw_qbatch_op
from repro_torch.kernels.envelope.ops import envelope_op
from repro_torch.kernels.lb_improved.ops import (
    combine_passes,
    lb_improved_pass2_pairs_op,
    lb_improved_qbatch_op,
)
from repro_torch.kernels.lb_keogh.ops import lb_keogh_pairs_op, lb_keogh_qbatch_op
from repro_torch.kernels.lb_kim.ops import lb_kim_qbatch_op
from repro_torch.kernels.tuning.table import resolve_config
from repro_torch.mv import tc as tc_mod

Method = Literal[
    "full", "lb_keogh", "lb_improved", "lb_webb", "kim_improved", "kim_webb",
    "tc_box", "tc_tri",
]


class TriContext(NamedTuple):
    """Reference-index context of the ``tc_tri`` stage (rooted distances;
    ``c_w`` is Theorem 1's banded constant, a scalar tensor), supplied by
    ``nn_search_indexed``."""

    d_q_refs: torch.Tensor  # (Q, R) DTW^w(q, r)
    d_q_refs_wide: torch.Tensor  # (Q, R) DTW^{2w}(q, r)
    d_ref_db: torch.Tensor  # (R, N) DTW^w(r, s)
    d_ref_db_wide: torch.Tensor  # (R, N) DTW^{2w}(r, s)
    c_w: torch.Tensor


class PipeContext(NamedTuple):
    """Per-call constants every stage closes over: the query batch, its
    envelopes (per channel segment at ``d > 1``), the band half-width and
    norm order, (only for pipelines with ``lb_webb`` at finite p) the
    query envelopes of envelopes, the channel count, and (only for
    ``tc_tri``) the block's global candidate ids and the reference-index
    context."""

    qs: torch.Tensor  # (Q, d*n)
    upper: torch.Tensor  # (Q, d*n)
    lower: torch.Tensor  # (Q, d*n)
    w: int
    p: PNorm
    q_ul: torch.Tensor | None = None  # (Q, d*n) upper envelope of lower
    q_lu: torch.Tensor | None = None  # (Q, d*n) lower envelope of upper
    d: int = 1
    cand_i: torch.Tensor | None = None  # (B,) global candidate ids of the block
    tri: TriContext | None = None


@dataclasses.dataclass(frozen=True)
class Stage:
    """One cascade stage.

    ``dense``  — (ctx, blk) -> (Q, B) powered values for a whole tile.
    ``pair``   — (ctx, blk, qi, ci, bound, prev) -> (chunk,) powered values
                 for compacted lane pairs; ``bound`` is each lane's powered
                 pruning bound, ``prev`` the previous stage's value.
    ``exact``  — True for the terminal stage (true distances, not bounds).
    """

    name: str
    dense: Callable[[PipeContext, torch.Tensor], torch.Tensor]
    pair: Callable[..., torch.Tensor]
    exact: bool = False


def query_webb_envelopes(upper, lower, w: int, d: int = 1):
    """(UL, LU): the upper envelope of L and the lower envelope of U (per
    channel segment), through the envelope kernel
    (``core.lb.envelope_of_envelopes``)."""
    return envelope_op(lower, w, d)[0], envelope_op(upper, w, d)[1]


# --------------------------------------------------------------- stages


def _lb_kim_dense(ctx: PipeContext, blk):
    return lb_kim_qbatch_op(blk, ctx.qs, None, ctx.p)


def _lb_kim_pair(ctx, blk, qi, ci, bound, prev):
    return lb_mod.lb_kim_powered(blk[ci], ctx.qs[qi], ctx.p)


def _lb_keogh_dense(ctx: PipeContext, blk):
    return lb_keogh_qbatch_op(blk, ctx.upper, ctx.lower, ctx.p)[0]


def _lb_keogh_pair(ctx, blk, qi, ci, bound, prev):
    return lb_keogh_pairs_op(blk, ctx.upper, ctx.lower, qi, ci, ctx.p)[0]


def _lb_improved_dense(ctx: PipeContext, blk):
    return lb_improved_qbatch_op(blk, ctx.qs, ctx.upper, ctx.lower, ctx.w, ctx.p, d=ctx.d)


def _lb_improved_pair(ctx, blk, qi, ci, bound, prev):
    """Corollary 4 per compacted lane pair: the projections H come from
    K2 on the pairs (bit-equal to ``project(blk[ci], U[qi], L[qi])``), K3
    adds pass 2 to the stage-1 LB_Keogh values ``prev``."""
    _, h = lb_keogh_pairs_op(blk, ctx.upper, ctx.lower, qi, ci, ctx.p)
    pass2 = lb_improved_pass2_pairs_op(h, ctx.qs, qi, ctx.w, ctx.p, ctx.d)
    return combine_passes(prev, pass2, ctx.p)


def _webb_q_envelopes(ctx: PipeContext):
    if ctx.p == math.inf:
        return None, None
    if ctx.q_ul is None:
        return query_webb_envelopes(ctx.upper, ctx.lower, ctx.w, ctx.d)
    return ctx.q_ul, ctx.q_lu


def _lb_webb_dense(ctx: PipeContext, blk):
    cand_u, cand_l = envelope_op(blk, ctx.w, ctx.d)
    q_ul, q_lu = _webb_q_envelopes(ctx)
    return lb_mod.lb_webb_powered_qbatch(
        blk, ctx.qs, ctx.upper, ctx.lower, ctx.w, ctx.p,
        q_ul=q_ul, q_lu=q_lu, cand_u=cand_u, cand_l=cand_l,
    )


def _lb_webb_pair(ctx, blk, qi, ci, bound, prev):
    """Webb query-side term per compacted lane pair, added to the gathered
    LB_Keogh values ``prev``."""
    c = blk[ci]
    cand_u, cand_l = envelope_op(c, ctx.w, ctx.d)
    q = ctx.qs[qi]
    if ctx.p == math.inf:
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        qside = lb_mod._webb_qside(q, cand_u, cand_l, zero, zero, ctx.p)
        return torch.maximum(prev, qside)
    q_ul, q_lu = _webb_q_envelopes(ctx)
    qside = lb_mod._webb_qside(q, cand_u, cand_l, q_ul[qi], q_lu[qi], ctx.p)
    return prev + qside


def _dtw_dense(ctx: PipeContext, blk):
    return dtw_qbatch_op(ctx.qs, blk, ctx.w, ctx.p, d=ctx.d)


def _dtw_pair(ctx, blk, qi, ci, bound, prev):
    """Banded DP on compacted lane pairs, early-abandoning against each
    lane's powered bound at finite p; p = inf runs the full DP, as the
    reference's ``dtw_banded_diag`` path does."""
    bounds = None if ctx.p == math.inf else bound.contiguous()
    return dtw_pairs_op(ctx.qs, blk, qi, ci, ctx.w, ctx.p, bounds, ctx.d)


# ------------------------------------------------------- TC-DTW stages


def _tc_box_dense(ctx: PipeContext, blk):
    return tc_mod.tc_box_powered_qbatch(blk, ctx.upper, ctx.lower, ctx.p, ctx.d)


def _tc_box_pair(ctx, blk, qi, ci, bound, prev):
    """The envelope box per compacted lane pair; it comes before LB_Keogh
    in its pipelines, so (like LB_Kim) it ignores ``prev``."""
    return tc_mod.tc_box_powered_pair(blk[ci], ctx.upper[qi], ctx.lower[qi], ctx.p, ctx.d)


def _tri_columns(ctx: PipeContext, ci=None):
    """The reference columns of the block's candidates (or of the lanes
    ``ci``), their ids clamped into the database (filler lanes are -1)."""
    tri = ctx.tri
    ids = ctx.cand_i if ci is None else ctx.cand_i[ci]
    safe = ids.clamp(0, tri.d_ref_db.shape[1] - 1)
    return tri.d_ref_db[:, safe], tri.d_ref_db_wide[:, safe]


def _tc_tri_dense(ctx: PipeContext, blk):
    if ctx.tri is None or ctx.cand_i is None:
        # no reference context in this driver: the zero bound is sound on
        # any non-negative distance and prunes nothing
        return torch.zeros((ctx.qs.shape[0], blk.shape[0]), dtype=blk.dtype,
                           device=blk.device)
    tri = ctx.tri
    cols, cols_wide = _tri_columns(ctx)
    return tc_mod.tc_tri_powered_qbatch(
        tri.d_q_refs, tri.d_q_refs_wide, cols, cols_wide, tri.c_w, ctx.p
    )


def _tc_tri_pair(ctx, blk, qi, ci, bound, prev):
    """LB_tri per compacted lane pair: O(R) gathers a lane; it ignores
    ``prev``."""
    if ctx.tri is None or ctx.cand_i is None:
        return torch.zeros(qi.shape[0], dtype=blk.dtype, device=blk.device)
    tri = ctx.tri
    cols, cols_wide = _tri_columns(ctx, ci)
    return tc_mod.tc_tri_powered_pair(
        tri.d_q_refs[qi], tri.d_q_refs_wide[qi], cols.T, cols_wide.T, tri.c_w, ctx.p
    )


STAGES: dict[str, Stage] = {
    "lb_kim": Stage("lb_kim", _lb_kim_dense, _lb_kim_pair),
    "lb_keogh": Stage("lb_keogh", _lb_keogh_dense, _lb_keogh_pair),
    "lb_improved": Stage("lb_improved", _lb_improved_dense, _lb_improved_pair),
    "lb_webb": Stage("lb_webb", _lb_webb_dense, _lb_webb_pair),
    "tc_box": Stage("tc_box", _tc_box_dense, _tc_box_pair),
    "tc_tri": Stage("tc_tri", _tc_tri_dense, _tc_tri_pair),
    "full": Stage("full", _dtw_dense, _dtw_pair, exact=True),
}

#: the cascade per method: LB stages in tightening order, terminal DP last.
PIPELINES: dict[str, tuple[str, ...]] = {
    "full": ("full",),
    "lb_keogh": ("lb_keogh", "full"),
    "lb_improved": ("lb_keogh", "lb_improved", "full"),
    "lb_webb": ("lb_keogh", "lb_webb", "full"),
    "kim_improved": ("lb_kim", "lb_keogh", "lb_improved", "full"),
    "kim_webb": ("lb_kim", "lb_keogh", "lb_webb", "full"),
    # the TC-DTW cascades: the coarse envelope box gates the per-sample
    # bounds; tc_tri puts the O(R) triangle bound first where the driver
    # threads the reference context in (elsewhere it prunes nothing)
    "tc_box": ("tc_box", "lb_keogh", "lb_improved", "full"),
    "tc_tri": ("tc_tri", "tc_box", "lb_keogh", "lb_improved", "full"),
}


def check_method(method: str) -> None:
    if method not in PIPELINES:
        raise ValueError(
            f"method={method!r} unknown; available stage pipelines: "
            f"{sorted(PIPELINES)}"
        )


def lb_stage_names(method: str) -> tuple[str, ...]:
    """The non-terminal (lower-bound) stages of a method's pipeline."""
    check_method(method)
    return PIPELINES[method][:-1]


# ---------------------------------------------------- compacted execution


def _compact_order(alive_flat: torch.Tensor) -> torch.Tensor:
    """Alive-first stable permutation of flat lane ids: sorting the dead
    mask moves alive lanes to the front in their original order."""
    return torch.argsort((~alive_flat).to(torch.uint8), stable=True)


def _run_stage_compacted(ctx, stage, blk, alive, bound, prev_vals, lane_chunk):
    """Run ``stage`` on the alive lanes of a ``(Q, B)`` tile.

    Survivors are compacted into ``lane_chunk``-sized gathers (the last
    one holds only the live remainder); past half the lanes the dense
    tile form runs instead.  Returns ``(vals (Q, B) powered, BIG on lanes
    not computed; lane_work)`` with ``lane_work`` chunk-padded as in the
    reference.
    """
    nq, b = alive.shape
    lanes = nq * b
    flat = alive.reshape(-1)
    count = int(flat.sum())
    big = torch.full((), BIG, dtype=blk.dtype, device=blk.device)
    if 2 * count > lanes:
        return torch.where(alive, stage.dense(ctx, blk), big), lanes
    order = _compact_order(flat)[:count]
    prev_flat = prev_vals.reshape(-1)
    vals = torch.full((lanes,), BIG, dtype=blk.dtype, device=blk.device)
    n_chunks = -(-count // lane_chunk)
    for i in range(n_chunks):
        sel = order[i * lane_chunk : (i + 1) * lane_chunk]
        qi, ci = sel // b, sel % b
        vals[sel] = stage.pair(ctx, blk, qi, ci, bound[qi], prev_flat[sel])
    return vals.reshape(nq, b), n_chunks * lane_chunk


class BlockStages(NamedTuple):
    """Result of one block through the pipeline (powered domain).

    ``d``        — (Q, B) distances; BIG on lanes that never reached the DP.
    ``masks``    — ``masks[0]`` the entry mask, ``masks[s]`` the lanes alive
                   after LB stage ``s``; ``masks[-1]`` the lanes the DP ran on.
    ``need_lb2`` — whether any lane entered a post-first LB stage.
    ``need_dtw`` — whether any lane entered the DP.
    ``dp_lane_work``   — DP lanes executed (chunk-padded).
    ``dp_lane_useful`` — DP lanes that were alive.
    """

    d: torch.Tensor
    masks: tuple[torch.Tensor, ...]
    need_lb2: bool
    need_dtw: bool
    dp_lane_work: int
    dp_lane_useful: int


def run_block_stages(
    qs, upper, lower, w: int, p: PNorm, method: str, blk, bound, mask0,
    lane_chunk: int | None = None, d: int = 1, ctx: PipeContext | None = None,
    first: torch.Tensor | None = None, cand_i: torch.Tensor | None = None,
    tri: TriContext | None = None,
) -> BlockStages:
    """One candidate block through the method's stage pipeline, query-major.

    ``blk`` is a ``(block, d*n)`` candidate tile (``d`` channels,
    channel-major flattened), ``bound`` a ``(Q,)`` powered pruning bound,
    ``mask0`` a ``(Q, block)`` bool of lanes alive on entry.  The first LB
    stage runs on the whole tile; every later stage runs
    survivor-compacted.  ``ctx`` may carry a prebuilt context (drivers
    build it once per query batch; its ``d`` then holds).  ``cand_i`` and
    ``tri``, the block's global candidate ids and the reference-index
    context, are read by the ``tc_tri`` stage only.  ``first`` may carry the first LB
    stage's (Q, block) powered values, already computed by the caller (the
    stream scanner's K7 over the block's flat segment); the stage then
    does not run on the tile.  ``lane_chunk`` left ``None``
    resolves from the active tune table (the "pipeline" family, keyed by
    the block's device type); it changes no distance or mask, only the
    chunk-padded ``dp_lane_work``.
    """
    if ctx is None:
        ctx = make_context(qs, upper, lower, w, p, method, d, tri)
    if cand_i is not None:
        ctx = ctx._replace(cand_i=cand_i)
    d = ctx.d
    nq, block = qs.shape[0], blk.shape[0]
    if lane_chunk is None:
        lane_chunk = resolve_config(
            "pipeline", b=block, n=blk.shape[1] // d, backend=blk.device.type,
            d=None if d == 1 else d,
        ).lane_chunk
    lane_chunk = int(lane_chunk)
    check_method(method)
    names = PIPELINES[method]
    stages = [STAGES[nm] for nm in names]

    alive = mask0
    masks = [mask0]
    vals = torch.full((nq, block), BIG, dtype=blk.dtype, device=blk.device)
    for si, stage in enumerate(stages):
        if stage.exact:
            need_lb2 = bool(masks[1].any()) if len(stages) > 2 else False
            need_dtw = bool(alive.any())
            dist, dp_work = _run_stage_compacted(
                ctx, stage, blk, alive, bound, vals, lane_chunk
            )
            dp_useful = int(alive.sum())
            return BlockStages(dist, tuple(masks), need_lb2, need_dtw, dp_work, dp_useful)
        if si == 0:
            vals = stage.dense(ctx, blk) if first is None else first
        else:
            vals, _ = _run_stage_compacted(ctx, stage, blk, alive, bound, vals, lane_chunk)
        alive = alive & (vals < bound[:, None])
        masks.append(alive)
    raise ValueError(f"pipeline for {method!r} has no terminal exact stage")


def make_context(qs, upper, lower, w: int, p: PNorm, method: str, d: int = 1,
                 tri: TriContext | None = None) -> PipeContext:
    """The stage context of one query batch of ``d``-channel rows; LB_Webb's
    correction envelopes depend only on the queries, so they are built
    here once."""
    ctx = PipeContext(qs, upper, lower, int(w), p, d=int(d), tri=tri)
    if "lb_webb" in PIPELINES[method] and p != math.inf:
        q_ul, q_lu = query_webb_envelopes(upper, lower, w, int(d))
        ctx = ctx._replace(q_ul=q_ul, q_lu=q_lu)
    return ctx
