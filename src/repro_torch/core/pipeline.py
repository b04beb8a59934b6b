"""Composable cascade stage pipeline with survivor compaction (univariate).

Port of ``repro.core.pipeline``.  Every bound is declared once as a
:class:`Stage` (a dense ``(Q, B)`` form and a compacted per-lane-pair
form) and listed in :data:`PIPELINES` per cascade method; the scan and
host drivers consume the registry.

On CUDA tensors the stages launch the hand-written kernels: LB_Kim (K6),
LB_Keogh and its projection (K2), LB_Improved pass 2 (K3), the banded DP
(K5) and the envelopes the stages need (K1).  LB_Webb has no kernel: like
the reference, which runs it as jnp code outside any kernel, it runs as
``core.lb`` tensor code on the device (its envelopes come from K1), as
does the per-pair LB_Kim form (LB_Kim is always a first, dense stage).
On CPU tensors every stage runs the plain PyTorch versions.

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

Method = Literal["full", "lb_keogh", "lb_improved", "lb_webb", "kim_improved", "kim_webb"]

#: multivariate cascades of the reference, ported with the mv tier
MV_METHODS = ("tc_box", "tc_tri")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a reference feature a later slice of the port adds."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md queue 1, "
        f"item {item}"
    )


def require_univariate(d: int) -> None:
    if int(d) != 1:
        raise not_ported(f"multivariate data (d={d})", "9 (multivariate)")


class PipeContext(NamedTuple):
    """Per-call constants every stage closes over: the query batch, its
    envelopes, the band half-width and norm order, and (only for
    pipelines with ``lb_webb`` at finite p) the query envelopes of
    envelopes."""

    qs: torch.Tensor  # (Q, n)
    upper: torch.Tensor  # (Q, n)
    lower: torch.Tensor  # (Q, n)
    w: int
    p: PNorm
    q_ul: torch.Tensor | None = None  # (Q, n) upper envelope of lower
    q_lu: torch.Tensor | None = None  # (Q, n) lower envelope of upper


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


def query_webb_envelopes(upper, lower, w: int):
    """(UL, LU): the upper envelope of L and the lower envelope of U,
    through the envelope kernel (``core.lb.envelope_of_envelopes``)."""
    return envelope_op(lower, w)[0], envelope_op(upper, w)[1]


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
    return lb_improved_qbatch_op(blk, ctx.qs, ctx.upper, ctx.lower, ctx.w, ctx.p)


def _lb_improved_pair(ctx, blk, qi, ci, bound, prev):
    """Corollary 4 per compacted lane pair: the projections H come from
    K2 on the pairs (bit-equal to ``project(blk[ci], U[qi], L[qi])``), K3
    adds pass 2 to the stage-1 LB_Keogh values ``prev``."""
    _, h = lb_keogh_pairs_op(blk, ctx.upper, ctx.lower, qi, ci, ctx.p)
    pass2 = lb_improved_pass2_pairs_op(h, ctx.qs, qi, ctx.w, ctx.p)
    return combine_passes(prev, pass2, ctx.p)


def _webb_q_envelopes(ctx: PipeContext):
    if ctx.p == math.inf:
        return None, None
    if ctx.q_ul is None:
        return query_webb_envelopes(ctx.upper, ctx.lower, ctx.w)
    return ctx.q_ul, ctx.q_lu


def _lb_webb_dense(ctx: PipeContext, blk):
    cand_u, cand_l = envelope_op(blk, ctx.w)
    q_ul, q_lu = _webb_q_envelopes(ctx)
    return lb_mod.lb_webb_powered_qbatch(
        blk, ctx.qs, ctx.upper, ctx.lower, ctx.w, ctx.p,
        q_ul=q_ul, q_lu=q_lu, cand_u=cand_u, cand_l=cand_l,
    )


def _lb_webb_pair(ctx, blk, qi, ci, bound, prev):
    """Webb query-side term per compacted lane pair, added to the gathered
    LB_Keogh values ``prev``."""
    c = blk[ci]
    cand_u, cand_l = envelope_op(c, ctx.w)
    q = ctx.qs[qi]
    if ctx.p == math.inf:
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        qside = lb_mod._webb_qside(q, cand_u, cand_l, zero, zero, ctx.p)
        return torch.maximum(prev, qside)
    q_ul, q_lu = _webb_q_envelopes(ctx)
    qside = lb_mod._webb_qside(q, cand_u, cand_l, q_ul[qi], q_lu[qi], ctx.p)
    return prev + qside


def _dtw_dense(ctx: PipeContext, blk):
    return dtw_qbatch_op(ctx.qs, blk, ctx.w, ctx.p)


def _dtw_pair(ctx, blk, qi, ci, bound, prev):
    """Banded DP on compacted lane pairs, early-abandoning against each
    lane's powered bound at finite p; p = inf runs the full DP, as the
    reference's ``dtw_banded_diag`` path does."""
    bounds = None if ctx.p == math.inf else bound.contiguous()
    return dtw_pairs_op(ctx.qs, blk, qi, ci, ctx.w, ctx.p, bounds)


STAGES: dict[str, Stage] = {
    "lb_kim": Stage("lb_kim", _lb_kim_dense, _lb_kim_pair),
    "lb_keogh": Stage("lb_keogh", _lb_keogh_dense, _lb_keogh_pair),
    "lb_improved": Stage("lb_improved", _lb_improved_dense, _lb_improved_pair),
    "lb_webb": Stage("lb_webb", _lb_webb_dense, _lb_webb_pair),
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
}


def check_method(method: str) -> None:
    if method in MV_METHODS:
        raise not_ported(f"method={method!r}", "9 (multivariate)")
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
    first: torch.Tensor | None = None,
) -> BlockStages:
    """One candidate block through the method's stage pipeline, query-major.

    ``blk`` is a ``(block, n)`` candidate tile, ``bound`` a ``(Q,)`` powered
    pruning bound, ``mask0`` a ``(Q, block)`` bool of lanes alive on entry.
    The first LB stage runs on the whole tile; every later stage runs
    survivor-compacted.  ``ctx`` may carry a prebuilt context (drivers
    build it once per query batch).  ``first`` may carry the first LB
    stage's (Q, block) powered values, already computed by the caller (the
    stream scanner's K7 over the block's flat segment); the stage then
    does not run on the tile.  ``lane_chunk`` left ``None``
    resolves from the active tune table (the "pipeline" family, keyed by
    the block's device type); it changes no distance or mask, only the
    chunk-padded ``dp_lane_work``.
    """
    require_univariate(d)
    nq, block = qs.shape[0], blk.shape[0]
    if lane_chunk is None:
        lane_chunk = resolve_config(
            "pipeline", b=block, n=blk.shape[1], backend=blk.device.type
        ).lane_chunk
    lane_chunk = int(lane_chunk)
    check_method(method)
    names = PIPELINES[method]
    if ctx is None:
        ctx = make_context(qs, upper, lower, w, p, method)
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


def make_context(qs, upper, lower, w: int, p: PNorm, method: str) -> PipeContext:
    """The stage context of one query batch; LB_Webb's correction
    envelopes depend only on the queries, so they are built here once."""
    ctx = PipeContext(qs, upper, lower, int(w), p)
    if "lb_webb" in PIPELINES[method] and p != math.inf:
        q_ul, q_lu = query_webb_envelopes(upper, lower, w)
        ctx = ctx._replace(q_ul=q_ul, q_lu=q_lu)
    return ctx
