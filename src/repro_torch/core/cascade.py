"""Two-pass pruned nearest-neighbour search — the paper's Algorithms 2/3.

Port of ``repro.core.cascade`` (scan, host and indexed drivers).  Candidates are
processed in blocks and queries in batches: each query lane keeps its own
top-k and prunes against its own tightening bound.

* ``nn_search_scan`` — a loop over blocks, each through the stage
  pipeline of ``repro_torch.core.pipeline`` (first LB stage dense, later
  stages survivor-compacted, the DP early-abandoning per lane), merged
  into each query's top-k by a stable sort, so a tie goes to the lower
  position as with the reference's ``lax.top_k``.
* ``nn_search_host`` — every LB stage dense per block, the survivors of
  the whole query batch pooled into ``dtw_chunk``-sized DP launches, and
  a stable host argsort merge.  At p in {1, 2} an LB_Keogh stage
  followed by LB_Improved runs as one fused launch (K4) per block.  A
  pipeline that is that fused step alone (``lb_improved``, the default),
  or LB_Kim then that step (``kim_improved``), runs its whole block loop
  on the tensors' device (``fused_block_loop``): per block K4, with
  LB_Kim as its entry for ``kim_improved``, writes each pair's stage,
  then K5 runs the survivors in place and, in the same launch, merges
  them into the top-k and the counters, with no copy back until the loop
  ends.  Every other pipeline (``kim_webb``, ``lb_webb``, ``lb_keogh``,
  ``full``) and p = inf take the host loop.
* ``nn_search_indexed`` — stage 0 through the triangle index
  (``repro_torch.index``): the reference DPs of the query batch, cluster
  and per-candidate LB_tri, then the scan driver's block body over the
  compacted survivors with a per-query entry mask, its top-k seeded with
  the exact reference distances.

All take numpy arrays or tensors.  They run on the tensors' device, or
on ``device`` (default: the GPU; ``RuntimeError`` when there is none).
Rows of ``d > 1`` channels are dependent multivariate series in the
channel-major flattened layout (``repro_torch.mv.layout``): ``w`` is
clamped to the per-channel length, the envelopes are per channel segment
and the DP is K5's channel entry.  At d > 1 only ``lb_improved`` at p in
{1, 2} takes the device loop, its K4 step composed of K2 and the folded
K3 (``kernels/lb_fused/ops.py::lb_fused_prepare``); ``kim_improved``
keeps the host loop there, as K4's kim entry serves d = 1 rows only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import pipeline as pipe
from repro_torch.core.dtw import BIG, PNorm, finish_cost
from repro_torch.index.triangle_lb import lb_triangle_batch, lb_triangle_clusters, powered
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.dtw.ops import dtw_masked_prepare, dtw_pairs_op, dtw_qbatch_op
from repro_torch.kernels.envelope.ops import envelope_op
from repro_torch.kernels.lb_fused.ops import lb_fused_prepare, lb_fused_qbatch_op

__all__ = [
    "BatchSearchResult",
    "SearchResult",
    "SearchStats",
    "fused_block_loop",
    "nn_search_host",
    "nn_search_indexed",
    "nn_search_scan",
]


@dataclasses.dataclass(frozen=True)
class SearchStats:
    """Per-candidate stage counts (paper semantics: Figs 6-10 'pruning').

    ``stage_pruned`` has one pruned count per LB stage of the method's
    pipeline (``stage_names``, cascade order), and
    ``sum(stage_pruned) + full_dtw (+ lb0_pruned) == n_candidates`` on
    every search path.  ``lb1_pruned`` is the first stage's count and
    ``lb2_pruned`` the sum of every later stage's.  ``blocks_*`` and the
    DP lane counters are batch-level execution counts.
    """

    n_candidates: int
    full_dtw: int  # candidates that reached the O(nw) DP
    stage_names: tuple[str, ...] = ()
    stage_pruned: tuple[int, ...] = ()
    blocks_total: int = 0
    blocks_lb2: int = 0  # blocks where a post-first LB stage ran
    blocks_dtw: int = 0  # blocks (scan) or DP chunks (host) that ran the DP
    dp_lane_work: int = 0  # DP lanes executed, chunk-padded
    dp_lane_useful: int = 0  # alive DP lanes among them
    # stage-0 triangle-index counters (nn_search_indexed only)
    lb0_pruned: int = 0  # discarded by LB_tri before any envelope work
    ref_dtw: int = 0  # exact reference DPs at query time (2R: band w and 2w)
    clusters_total: int = 0
    clusters_pruned: int = 0  # clusters discarded wholesale at stage 0

    @property
    def lb1_pruned(self) -> int:
        """Candidates discarded by the first LB stage."""
        return int(self.stage_pruned[0]) if self.stage_pruned else 0

    @property
    def lb2_pruned(self) -> int:
        """Candidates discarded by every later LB stage."""
        return int(sum(self.stage_pruned[1:]))

    @property
    def pruned_by(self) -> dict[str, int]:
        """Per-stage pruned counts keyed by registry stage name."""
        return dict(zip(self.stage_names, self.stage_pruned))

    @property
    def pruning_ratio(self) -> float:
        if self.n_candidates == 0:
            return 0.0
        return 1.0 - self.full_dtw / self.n_candidates

    @property
    def stage0_ratio(self) -> float:
        """Fraction of candidates killed before any per-candidate LB work."""
        if self.n_candidates == 0:
            return 0.0
        return self.lb0_pruned / self.n_candidates

    @property
    def dp_lane_efficiency(self) -> float:
        """useful / work of the DP lanes executed (1.0 when the DP never
        ran): how much of the dispatched DP was not padding."""
        if self.dp_lane_work == 0:
            return 1.0
        return self.dp_lane_useful / self.dp_lane_work


@dataclasses.dataclass(frozen=True)
class SearchResult:
    distances: np.ndarray  # (k,) ascending
    indices: np.ndarray  # (k,)
    stats: SearchStats

    @property
    def distance(self) -> float:
        return float(self.distances[0])

    @property
    def index(self) -> int:
        return int(self.indices[0])


@dataclasses.dataclass(frozen=True)
class BatchSearchResult:
    """Results for a ``(Q, n)`` query batch; ``result[i]`` is query i's
    ``SearchResult`` and ``stats`` aggregates the batch."""

    distances: np.ndarray  # (Q, k)
    indices: np.ndarray  # (Q, k)
    stats: SearchStats
    per_query: tuple[SearchStats, ...] = ()

    def __len__(self) -> int:
        return int(self.distances.shape[0])

    def __getitem__(self, i: int) -> SearchResult:
        stats = self.per_query[i] if self.per_query else self.stats
        return SearchResult(
            distances=self.distances[i], indices=self.indices[i], stats=stats
        )

    def __iter__(self) -> Iterator[SearchResult]:
        return (self[i] for i in range(len(self)))


def _as_inputs(q, db, device, d: int):
    """(qs (Q, d*n), db (N, d*n), single, d) as tensors on one device;
    numpy queries take the database's dtype."""
    d = int(d)
    if d < 1 or np.shape(db)[-1] % d:
        raise ValueError(f"row length {np.shape(db)[-1]} not a multiple of d={d}")
    dev = resolve_device(device, like=db if isinstance(db, torch.Tensor) else q)
    db_t = torch.as_tensor(db, device=dev)
    if db_t.dtype not in (torch.float32, torch.float64):
        db_t = db_t.to(torch.float32)
    q_t = torch.as_tensor(q, device=dev).to(db_t.dtype)
    single = q_t.ndim == 1
    qs = q_t[None, :] if single else q_t
    return qs.contiguous(), db_t.contiguous(), single, d


def _pad_db(db: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    n_db = db.shape[0]
    n_pad = (-n_db) % block
    if n_pad:
        # pad rows never win: their LB vs any envelope is huge
        filler = db.new_full((n_pad, db.shape[1]), 0.5 * BIG ** 0.25)
        db = torch.cat([db, filler], dim=0)
    return db, n_pad


def init_carry(k: int, nq: int, n_lb: int, dtype, device, top_v=None, top_i=None):
    """Fresh query-major carry: (top_v (Q, k), top_i (Q, k), gbound (Q,),
    stage_pruned (S, Q), dtw_count (Q,), lb2_blocks, dtw_blocks,
    dp_lane_work, dp_lane_useful); optionally seeded with an already
    known (Q, k) top-k (the indexed search seeds it with the exact
    reference distances).  ``gbound`` starts at BIG: only the sharded
    search lowers it, to the bound its shards exchange."""
    return (
        torch.full((nq, k), BIG, dtype=dtype, device=device) if top_v is None
        else torch.as_tensor(top_v, dtype=dtype, device=device),
        torch.full((nq, k), -1, dtype=torch.int64, device=device) if top_i is None
        else torch.as_tensor(top_i, dtype=torch.int64, device=device),
        torch.full((nq,), BIG, dtype=dtype, device=device),
        torch.zeros((n_lb, nq), dtype=torch.int64, device=device),
        torch.zeros((nq,), dtype=torch.int64, device=device),
        0, 0, 0, 0,
    )


def make_block_step(ctx: pipe.PipeContext, k: int, block: int, method: str,
                    n_real: int | None = None):
    """The per-block body of the scan, indexed and sharded drivers: run
    the block's stages against each query's k-th best (or the carry's
    ``gbound``, where lower), merge into the top-k by a stable sort, and
    count.

    ``body(carry, blk, cand_i, mask0=None)``: ``cand_i`` is the (block,)
    vector of candidate ids (a contiguous range for the plain scan, a
    compacted survivor gather for ``nn_search_indexed``), and ``mask0`` a
    (Q, block) bool of the lanes alive on entry (each query's stage-0
    survivors).  Without ``mask0``, lanes with ``cand_i >= n_real``
    (database pad rows) are masked off, and with no ``n_real`` either
    every lane is alive.  Masked lanes are neither evaluated nor
    counted."""
    nq = ctx.qs.shape[0]
    n_lb = len(pipe.lb_stage_names(method))
    every_lane = torch.ones((nq, block), dtype=torch.bool, device=ctx.qs.device)

    def body(carry, blk, cand_i, mask0=None):
        top_v, top_i, gbound, c_stage, c_dtw, b_lb2, b_dtw, w_dp, u_dp = carry
        if mask0 is None:
            mask0 = every_lane if n_real is None else (cand_i < n_real)[None, :].expand(nq, block)
        bound = torch.minimum(top_v[:, -1], gbound)
        st = pipe.run_block_stages(
            ctx.qs, ctx.upper, ctx.lower, ctx.w, ctx.p, method, blk, bound,
            mask0, ctx=ctx, cand_i=cand_i,
        )
        all_v = torch.cat([top_v, st.d], dim=1)
        all_i = torch.cat([top_i, cand_i[None, :].expand(nq, block)], dim=1)
        sel = torch.argsort(all_v, dim=1, stable=True)[:, :k]
        top_v = torch.gather(all_v, 1, sel)
        top_i = torch.gather(all_i, 1, sel)
        if n_lb:
            c_stage = c_stage + torch.stack(
                [(st.masks[s] & ~st.masks[s + 1]).sum(dim=1) for s in range(n_lb)]
            )
        c_dtw = c_dtw + st.masks[-1].sum(dim=1)
        return (
            top_v, top_i, gbound, c_stage, c_dtw,
            b_lb2 + int(st.need_lb2), b_dtw + int(st.need_dtw),
            w_dp + st.dp_lane_work, u_dp + st.dp_lane_useful,
        )

    return body


def _batch_stats(
    n_db, stage_names, stage_pruned, c3, b2, b3, blocks_total,
    dp_lane_work=0, dp_lane_useful=0, per_query_stage0=None,
):
    """Per-query and aggregated stats from the per-stage counter vectors
    (``stage_pruned`` is (S, Q) in ``stage_names`` order).
    ``per_query_stage0`` optionally carries each query's stage-0 counters
    (lb0_pruned, ref_dtw, clusters_*) from the indexed path; the
    aggregate sums them over the queries."""
    nq = len(c3)
    stage_pruned = np.asarray(stage_pruned).reshape(len(stage_names), nq)
    s0_per = per_query_stage0 if per_query_stage0 is not None else [{}] * nq
    per_query = tuple(
        SearchStats(
            n_candidates=n_db,
            stage_names=tuple(stage_names),
            stage_pruned=tuple(int(v) for v in stage_pruned[:, i]),
            full_dtw=int(c3[i]),
            blocks_total=blocks_total,
            blocks_lb2=int(b2),
            blocks_dtw=int(b3),
            dp_lane_work=int(dp_lane_work),
            dp_lane_useful=int(dp_lane_useful),
            **s0_per[i],
        )
        for i in range(nq)
    )
    agg = SearchStats(
        n_candidates=nq * n_db,
        stage_names=tuple(stage_names),
        stage_pruned=tuple(int(v) for v in stage_pruned.sum(axis=1)),
        full_dtw=sum(s.full_dtw for s in per_query),
        blocks_total=blocks_total,
        blocks_lb2=int(b2),
        blocks_dtw=int(b3),
        dp_lane_work=int(dp_lane_work),
        dp_lane_useful=int(dp_lane_useful),
        lb0_pruned=sum(s.lb0_pruned for s in per_query),
        ref_dtw=sum(s.ref_dtw for s in per_query),
        clusters_total=sum(s.clusters_total for s in per_query),
        clusters_pruned=sum(s.clusters_pruned for s in per_query),
    )
    return agg, per_query


def _result(distances, indices, single, agg, per_query):
    if single:
        return SearchResult(distances=distances[0], indices=indices[0], stats=per_query[0])
    return BatchSearchResult(
        distances=distances, indices=indices, stats=agg, per_query=per_query
    )


def nn_search_scan(
    q, db, w: int, p: PNorm = 1, k: int = 1, block: int = 32,
    method: str = "lb_improved", d: int = 1, device=None,
) -> SearchResult | BatchSearchResult:
    """Block-scan cascade.  ``q`` is one series (d*n,) -> ``SearchResult``
    or a batch (Q, d*n) -> ``BatchSearchResult`` (one shared sweep)."""
    qs, db_t, single, d = _as_inputs(q, db, device, d)
    pipe.check_method(method)
    nq, n = qs.shape
    n_db = db_t.shape[0]
    w = int(min(w, n // d - 1))  # clamped to the per-channel length
    upper, lower = envelope_op(qs, w, d)
    ctx = pipe.make_context(qs, upper, lower, w, p, method, d)
    dbp, _ = _pad_db(db_t, block)
    nb = dbp.shape[0] // block
    body = make_block_step(ctx, int(k), int(block), method, n_db)
    n_lb = len(pipe.lb_stage_names(method))
    carry = init_carry(int(k), nq, n_lb, db_t.dtype, db_t.device)
    lanes = torch.arange(block, device=db_t.device)
    for t in range(nb):
        carry = body(carry, dbp[t * block : (t + 1) * block], t * block + lanes)
    top_v, top_i, _, cs, c3, b2, b3, w_dp, u_dp = carry
    agg, per_query = _batch_stats(
        n_db, pipe.lb_stage_names(method), cs.cpu().numpy(), c3.cpu().numpy(),
        b2, b3, blocks_total=nb, dp_lane_work=w_dp, dp_lane_useful=u_dp,
    )
    distances = finish_cost(top_v, p).cpu().numpy()
    return _result(distances, top_i.cpu().numpy(), single, agg, per_query)


# ------------------------------------------------------------------ host


def _dtw_pairs_block(qs, db, qidx, cidx, w, p, bounds=None, d: int = 1):
    """Banded DP over explicit (query, candidate) row pairs, the pooled
    survivor chunks of the host driver; the DP kernel gathers the rows
    from ``qs`` and ``db`` itself.  ``bounds`` (P,) enables abandoning."""
    return dtw_pairs_op(qs, db, qidx, cidx, w, p, bounds, d)


def _host_steps(names: tuple[str, ...], p: PNorm) -> list[tuple[int, ...]]:
    """The LB stages of a pipeline grouped into launches: ``lb_keogh``
    immediately followed by ``lb_improved`` is one fused launch at p in
    {1, 2} (the fused kernel's norms); every other stage is its own."""
    steps, i = [], 0
    while i < len(names):
        if p in (1, 2) and names[i : i + 2] == ("lb_keogh", "lb_improved"):
            steps.append((i, i + 1))
        else:
            steps.append((i,))
        i += len(steps[-1])
    return steps


def fused_block_loop(qs, db, upper, lower, w: int, p: PNorm, k: int, block: int,
                     dtw_chunk: int, early_abandon: bool = False, kim: bool = False,
                     d: int = 1):
    """The host driver's block loop for the fused LB_Keogh -> LB_Improved
    pipeline (``lb_improved``), or with ``kim`` for LB_Kim -> that pair
    (``kim_improved``), resident on the tensors' device.  Per block of
    ``block`` rows, in stream order and with no synchronisation:

    1. K4 against each query's k-th best (a view of ``top_v``) writes
       each pair's stage (0 pruned by LB_Keogh, 1 by LB_Improved, 2
       survivor, 255 a pad row of the tail block; with ``kim``, 0 pruned
       by LB_Kim and the rest one higher, its query features computed by
       K6's feature phase once before the loop);
    2. K5's masked-dense entry runs the DP on the survivors, abandoning
       against the same k-th best when ``early_abandon`` (an abandoned
       value is >= that bound, so it never enters the top-k), and in the
       same launch merges the survivors into each query's top-k (a
       stable merge: an equal value never displaces an entry, a lower
       row wins a tie) and adds the counters of the host loop that pooled
       them into ``dtw_chunk``-sized launches.

    Returns device tensors: top_v (Q, k) powered, top_i (Q, k), counts
    (n_lb + 1, Q) (pruned by each LB stage, then survivors; n_lb = 2, or
    3 with ``kim``) and totals (blocks_lb2, blocks_dtw, dp_lane_work,
    dp_lane_useful).  On CPU tensors every step is its kernel's plain
    version.  Rows of ``d > 1`` channels (no ``kim``) take step 1 as K2
    and the folded K3 with the stages written by tensor operations on the
    device, and step 2 in K5's channel entry.
    """
    dev, dt = db.device, db.dtype
    nq, n = qs.shape
    n_db = db.shape[0]
    top_v = torch.full((nq, k), BIG, dtype=dt, device=dev)
    top_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros((3 + int(kim), nq), dtype=torch.int64, device=dev)
    totals = torch.zeros(4, dtype=torch.int64, device=dev)
    stage = torch.empty((nq, block), dtype=torch.uint8, device=dev)
    dvals = torch.empty((nq, block), dtype=dt, device=dev)
    bound = top_v[:, -1]  # read by each launch: the k-th best so far
    lbs = lb_fused_prepare(qs, upper, lower, w, bound, p, block, stage, kim=kim, d=d)
    dp_merge = dtw_masked_prepare(qs, w, p, stage, bound if early_abandon else None, dvals,
                                  merge=(top_v, top_i, counts, totals, dtw_chunk), d=d)
    for lo in range(0, n_db, block):
        real = min(block, n_db - lo)
        cands = db[lo : lo + block]
        if real < block:  # pad the tail block with its last row
            cands = torch.cat([cands, cands[-1:].expand(block - real, n)], dim=0)
        lbs(cands, real)
        dp_merge(cands, lo)
    return top_v, top_i, counts, totals


def _to_host(*tensors) -> list[np.ndarray]:
    """Numpy copies of several device tensors through one transfer: their
    bytes are packed on the device, copied back once and split."""
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    raw = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        size = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(raw[at : at + size].view(dtype).reshape(t.shape).copy())
        at += size
    return out


def nn_search_host(
    q, db, w: int, p: PNorm = 1, k: int = 1, block: int = 256,
    dtw_chunk: int = 16, method: str = "lb_improved",
    early_abandon: bool = False, d: int = 1, device=None,
) -> SearchResult | BatchSearchResult:
    """Host-orchestrated cascade with survivor compaction.

    Per block, every LB stage of the method runs dense over the whole
    query batch (later stages only while lanes survive); the surviving
    (query, candidate) pairs of the whole batch are pooled into
    ``dtw_chunk``-sized DP launches and merged into each query's top-k by
    a stable host argsort.  At p in {1, 2} an LB_Keogh -> LB_Improved
    pair is one ``lb_fused_qbatch_op`` per block against each query's
    k-th best, copied to the host once: its masks are ``lb1 < bound``,
    then ``lb < bound``, as the two stages would give.  When that fused
    pair is the whole pipeline (``lb_improved``), or LB_Kim then that
    pair (``kim_improved``, d = 1 only), the loop runs on the device
    instead (``fused_block_loop``) with the same answers and counters.
    ``early_abandon`` additionally stops each DP once its band clears
    the running bound.  ``d > 1``: rows of d channels, channel-major
    flattened.
    """
    qs, db_t, single, d = _as_inputs(q, db, device, d)
    pipe.check_method(method)
    nq, n = qs.shape
    n_db = db_t.shape[0]
    w = int(min(w, n // d - 1))  # clamped to the per-channel length
    upper, lower = envelope_op(qs, w, d)
    lb_names = pipe.lb_stage_names(method)
    steps = _host_steps(lb_names, p)
    nb = -(-n_db // block)
    kim = steps == [(0,), (1, 2)] and lb_names[0] == "lb_kim" and d == 1
    if steps == [(0, 1)] or kim:
        top_v, top_i, counts, totals = _to_host(*fused_block_loop(
            qs, db_t, upper, lower, w, p, k, block, dtw_chunk, early_abandon, kim=kim,
            d=d,
        ))
        n_lb = len(lb_names)
        agg, per_query = _batch_stats(
            n_db, lb_names, counts[:n_lb], counts[n_lb], totals[0], totals[1],
            blocks_total=nb, dp_lane_work=totals[2], dp_lane_useful=totals[3],
        )
        distances = finish_cost(torch.as_tensor(top_v), p).numpy()
        return _result(distances, top_i, single, agg, per_query)
    ctx = pipe.make_context(qs, upper, lower, w, p, method, d)
    dev = db_t.device

    top_v = np.full((nq, k), BIG)
    top_i = np.full((nq, k), -1, np.int64)
    lb_pruned = np.zeros((len(lb_names), nq), np.int64)
    c3 = np.zeros(nq, np.int64)
    blocks_lb2 = blocks_dtw = 0
    dp_lane_work = dp_lane_useful = 0

    def merge(qi: int, vals: np.ndarray, idxs: np.ndarray):
        av = np.concatenate([top_v[qi], vals])
        ai = np.concatenate([top_i[qi], idxs])
        order = np.argsort(av, kind="stable")[:k]
        top_v[qi], top_i[qi] = av[order], ai[order]

    def step_values(step, blk, bound, real):
        """(len(step), Q, real) stage values of one launch, on the host."""
        if len(step) == 2:
            bound_t = torch.as_tensor(bound, dtype=db_t.dtype, device=dev)
            vals = torch.stack(lb_fused_qbatch_op(blk, qs, upper, lower, w, bound_t, p, d=d))
        else:
            vals = pipe.STAGES[lb_names[step[0]]].dense(ctx, blk)[None]
        return vals[:, :, :real].cpu().numpy()

    for t in range(nb):
        lo, hi = t * block, min((t + 1) * block, n_db)
        blk = db_t[lo:hi]
        if blk.shape[0] < block:  # pad the tail block with its last row
            blk = torch.cat([blk, blk[-1:].expand(block - blk.shape[0], n)], dim=0)
        bound = top_v[:, -1]

        alive = np.ones((nq, hi - lo), bool)
        for step in steps:
            if step[0] > 0 and not alive.any():
                break
            for si, lb in zip(step, step_values(step, blk, bound, hi - lo)):
                if si > 0:
                    if not alive.any():
                        break
                    if si == 1:
                        blocks_lb2 += 1
                alive_next = alive & (lb < bound[:, None])
                lb_pruned[si] += (alive & ~alive_next).sum(axis=1)
                alive = alive_next

        # pooled survivor pairs, query-major
        pair_q, pair_c = np.nonzero(alive)
        pair_c = pair_c + lo
        c3 += alive.sum(axis=1)
        for s0 in range(0, len(pair_q), dtw_chunk):
            sel_q = pair_q[s0 : s0 + dtw_chunk]
            sel_c = pair_c[s0 : s0 + dtw_chunk]
            blocks_dtw += 1
            dp_lane_work += dtw_chunk
            dp_lane_useful += len(sel_q)
            qi_t = torch.as_tensor(sel_q, dtype=torch.int64, device=dev)
            ci_t = torch.as_tensor(sel_c, dtype=torch.int64, device=dev)
            bounds = None
            if early_abandon:
                bounds = torch.as_tensor(top_v[sel_q, -1], dtype=db_t.dtype, device=dev)
            dvals = _dtw_pairs_block(qs, db_t, qi_t, ci_t, w, p, bounds, d).cpu().numpy()
            for qi in np.unique(sel_q):
                sel = sel_q == qi
                merge(int(qi), dvals[sel], sel_c[sel])

    agg, per_query = _batch_stats(
        n_db, lb_names, lb_pruned, c3, blocks_lb2, blocks_dtw, blocks_total=nb,
        dp_lane_work=dp_lane_work, dp_lane_useful=dp_lane_useful,
    )
    distances = finish_cost(torch.as_tensor(top_v, dtype=db_t.dtype), p).numpy()
    return _result(distances, top_i, single, agg, per_query)


# --------------------------------------------------------------- indexed


def nn_search_indexed(
    q, db, index, k: int = 1, block: int = 32, method: str = "lb_improved",
    device=None,
) -> SearchResult | BatchSearchResult:
    """Four-stage search: LB_tri -> LB_Keogh -> LB_Improved -> DTW.

    ``index`` is a prebuilt ``repro_torch.index.TriangleIndex`` over
    ``db``; ``w``, ``p`` and the channel count ``d`` come from the index
    (Theorem 1's constant depends on w and p).  ``q`` is one series
    (d*n,) -> ``SearchResult`` or a batch (Q, d*n) -> ``BatchSearchResult``.
    A pipeline with ``tc_tri`` re-applies LB_tri per block against the
    running bound, from the reference distances of stage 0
    (``core.pipeline.TriContext``).

    Stage 0 spends 2R exact DPs per query on the references (band w and
    the composed band 2w), two launches of the DP kernel for the whole
    batch.  References are database rows, so the band-w distances seed
    the top-k with true distances; then whole clusters and single
    candidates die with O(R) arithmetic per candidate, on the device.
    The survivors of every query are compacted into one candidate list
    and swept by the scan driver's block body (``make_block_step``) with
    a (Q, block) entry mask per block, so each query lane evaluates and
    counts only its own survivors.  The reference pads that list to a
    power-of-two number of blocks (its jit specialisations); the port
    reports the same ``blocks_total`` but launches nothing for the
    padding blocks, whose lanes are masked for every query (such a block
    moves no counter in the reference either).

    Stats specific to this path: ``lb0_pruned`` (killed at stage 0),
    ``ref_dtw`` (2R), ``clusters_total`` / ``clusters_pruned``; and
    ``full_dtw`` includes the R band-w reference DPs, so
    ``lb0 + sum(stage_pruned) + full_dtw == n_candidates`` per query.
    """
    qs, db_t, single, d = _as_inputs(q, db, device, int(getattr(index, "d", 1)))
    pipe.check_method(method)
    nq, n = qs.shape
    n_db = db_t.shape[0]
    dev = db_t.device
    w, p = index.w, (math.inf if math.isinf(index.p) else index.p)
    if p != math.inf and float(p) == int(p):
        p = int(p)
    index.validate(n_db, n // d, w, p, d)
    cl = index.clustering
    c_w = index.constant
    n_refs = index.n_refs
    arrs = index.device_arrays(dev, qs.dtype)  # build-time constants, uploaded once
    ref_idx = np.asarray(index.ref_idx, np.int64)
    ref_idx_t = torch.as_tensor(ref_idx, device=dev)

    # cheap guard against serving a different database of the same shape
    # (a stale index would silently prune true neighbours): the R
    # reference rows are read back, not the database
    ref_rows = db_t[ref_idx_t].cpu().numpy().astype(np.float32)
    if not np.array_equal(ref_rows, np.asarray(index.ref_series, np.float32)):
        raise ValueError(
            "database rows at ref_idx do not match the index's reference "
            "series — the index belongs to a different database"
        )

    # ---- stage 0a: exact DTW to the references at both bands, rooted
    refs = arrs["ref_series"].to(qs.dtype).contiguous()
    d_q_refs = finish_cost(dtw_qbatch_op(qs, refs, w, p, d=d), p)  # (Q, R)
    d_q_refs_wide = finish_cost(dtw_qbatch_op(qs, refs, index.w_wide, p, d=d), p)
    ref_pow = powered(d_q_refs.cpu().numpy(), p)
    order = np.argsort(ref_pow, axis=1, kind="stable")
    top_v = np.full((nq, k), BIG)  # float64 on the host, as the reference's
    top_i = np.full((nq, k), -1, np.int64)
    m = min(k, n_refs)
    top_v[:, :m] = np.take_along_axis(ref_pow, order[:, :m], axis=1)
    top_i[:, :m] = ref_idx[order[:, :m]]
    # powered k-th best so far; the float32 bounds below are compared
    # against it in float64, the reference's promotion
    bound = torch.as_tensor(top_v[:, -1], device=dev)[:, None]

    # ---- stage 0b: cluster-granularity pruning (O(C) work per query)
    reps = torch.as_tensor(cl.rep_rows, device=dev)
    cl_lb = lb_triangle_clusters(
        d_q_refs[:, reps], d_q_refs_wide[:, reps], arrs["radii"], arrs["min_radii_wide"], c_w
    )
    cl_alive = powered(cl_lb, p) < bound  # (Q, C)
    alive = cl_alive[:, torch.as_tensor(cl.assign, device=dev)]  # (Q, N)

    # ---- stage 0c: per-candidate LB_tri over all references (O(R) each)
    lb0 = lb_triangle_batch(
        d_q_refs, d_q_refs_wide, arrs["d_ref_db"], arrs["d_ref_db_wide"], c_w
    )
    alive &= powered(lb0, p) < bound
    alive[:, ref_idx_t] = False  # references were evaluated exactly above
    alive, cl_alive = _to_host(alive, cl_alive)
    per_q_survivors = alive.sum(axis=1)
    lb0_pruned = n_db - n_refs - per_q_survivors
    # stages 1-3 sweep the union of the per-query survivor sets once
    survivors = np.nonzero(alive.any(axis=0))[0]
    stage0_per = [
        dict(
            lb0_pruned=int(lb0_pruned[i]),
            ref_dtw=2 * n_refs,
            clusters_total=cl.n_clusters,
            clusters_pruned=int((~cl_alive[i]).sum()),
        )
        for i in range(nq)
    ]
    lb_names = pipe.lb_stage_names(method)
    if len(survivors) == 0:
        agg, per_query = _batch_stats(
            n_db, lb_names, np.zeros((len(lb_names), nq), np.int64),
            np.full(nq, n_refs, np.int64), 0, 0, blocks_total=0,
            per_query_stage0=stage0_per,
        )
        distances = finish_cost(torch.as_tensor(top_v, dtype=qs.dtype), p).numpy()
        return _result(distances, top_i, single, agg, per_query)

    # ---- stages 1-3: the masked, seeded block scan over the survivors
    nb = -(-len(survivors) // block)
    nb_pad = 1 << (nb - 1).bit_length()  # the reference's power-of-two count
    total = nb * block
    idx = np.concatenate([survivors, np.full(total - len(survivors), -1, np.int64)])
    # (Q, total) entry mask: each lane alive only for the queries that
    # still need it; the filler lanes of the last block are dead for all
    mask = np.zeros((nq, total), bool)
    mask[:, : len(survivors)] = alive[:, survivors]
    idx_t = torch.as_tensor(idx, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    w_scan = int(min(w, n // d - 1))
    upper, lower = envelope_op(qs, w_scan, d)
    # a pipeline with tc_tri re-applies LB_tri per block against the
    # running bound (stage 0 saw only the reference-seeded one)
    tri = None
    if "tc_tri" in pipe.PIPELINES[method]:
        tri = pipe.TriContext(
            d_q_refs, d_q_refs_wide, arrs["d_ref_db"], arrs["d_ref_db_wide"],
            torch.tensor(c_w, dtype=d_q_refs.dtype, device=dev),
        )
    ctx = pipe.make_context(qs, upper, lower, w_scan, p, method, d, tri)
    body = make_block_step(ctx, int(k), int(block), method)
    carry = init_carry(int(k), nq, len(lb_names), qs.dtype, dev, top_v, top_i)
    for t in range(nb):
        lanes = slice(t * block, (t + 1) * block)
        real = min(block, len(survivors) - t * block)
        blk = db_t.index_select(0, idx_t[t * block : t * block + real])
        if real < block:  # filler rows never win: masked off on entry
            blk = torch.cat([blk, blk.new_full((block - real, n), 0.5 * BIG ** 0.25)])
        carry = body(carry, blk, idx_t[lanes], mask_t[:, lanes])
    top_v_t, top_i_t, _, cs, c3, b2, b3, w_dp, u_dp = carry
    # the R band-w reference DPs count as full_dtw: they seed the top-k
    # with true distances
    agg, per_query = _batch_stats(
        n_db, lb_names, cs.cpu().numpy(), c3.cpu().numpy() + n_refs, b2, b3,
        blocks_total=nb_pad, dp_lane_work=w_dp, dp_lane_useful=u_dp,
        per_query_stage0=stage0_per,
    )
    distances = finish_cost(top_v_t, p).cpu().numpy()
    return _result(distances, top_i_t.cpu().numpy(), single, agg, per_query)
