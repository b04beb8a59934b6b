"""Budgeted best-first exploration of the cluster tree (port of
``repro.anytime.search``; DESIGN.md §3.10).

The anytime query phase is a best-first frontier search:

1. **Seed**: the coarse representatives are refined exactly (they seed
   best-so-far), and per-cluster lower bounds are computed from the
   query: the envelope-box bound (``core.lb.lb_box_powered``) maxed
   with the Theorem 1 triangle bound from the representative distances
   and stored radii (``index.triangle_lb.lb_triangle_clusters``).
2. **Explore**: a min-heap over tree nodes keyed by powered LB.
   Popping a coarse node expands its leaves (free: the leaf bound is
   ``max(leaf box LB, parent LB)``, so bounds only tighten going down);
   popping a leaf *refines* its member windows through the standard
   stage pipeline (``core.pipeline.run_block_stages``), spending one
   unit of budget per member window.
3. **Stop**: when the budget is spent, when the frontier is empty, or
   when the heap minimum exceeds the current kth distance (the answer is
   then provably exact).

Everything that can enter the top-k pool goes through
``run_block_stages`` with the *strict* gate ``nextafter(kth)``: a lane
is only pruned or abandoned when its bound provably exceeds the kth
distance, so exact ties survive, and the pool keeps the k smallest under
the lexicographic ``(distance, window id)`` order, the order the block
sweep realises implicitly (earlier ids win ties).  Both make the result
independent of the refinement order: with an unexhausted budget the
anytime answer bit-matches ``mode="exact"``.

**Error bound.**  On exit, ``residual`` is the smallest LB over the
unexplored frontier (``+inf`` when none remains).  For the j-th reported
answer ``d_j`` the true j-th distance satisfies ``t_j >= min(d_j,
residual)``, so ``err_j = max(0, d_j - residual)`` bounds ``d_j - t_j``
and is 0 exactly when exploration finished.

What runs where.  The query's envelope is the envelope kernel (K1,
``envelope_op``) on the tier's device; the 2·C representative distances
are the DP kernel's dense entry (K5, ``dtw_qbatch_op``) at the tier's
band and at the wide band; the cluster bounds are tensor code there,
against the boxes and radii uploaded once per tier (``LengthIndex.cache``).
Each refined leaf, and each block of the exact sweep, is gathered from
the window bank on the device (``index_select``), padded with zero rows
to a power of two, and run through ``run_block_stages``: on CUDA tensors
LB_Keogh (K2) on the tile, K2 and LB_Improved's pass 2 (K3) on the pairs
that pass it, and K5's pair entry abandoning against the gate at finite
p; CPU tensors run the plain versions.  The heap, the pool and the error
bounds stay on the host in the reference's order (numpy); the pool's
distances are rooted on the bank's device, as the drivers root theirs,
so that an unlimited budget gives ``mode="exact"``'s bits on either
device.  Results are numpy like the drivers'.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np
import torch

from repro_torch.anytime.build import AnytimeIndex, LengthIndex
from repro_torch.core import pipeline
from repro_torch.core.dtw import BIG, PNorm, finish_cost
from repro_torch.core.lb import lb_box_powered
from repro_torch.core.metrics import theorem1_bound
from repro_torch.core.pipeline import Method, lb_stage_names
from repro_torch.index.triangle_lb import lb_triangle_clusters, powered, wide_band
from repro_torch.kernels.dtw.ops import dtw_qbatch_op
from repro_torch.kernels.envelope.ops import envelope_op

__all__ = [
    "AnytimeStats",
    "AnytimeResult",
    "AnytimeBatchResult",
    "anytime_search",
    "exact_subsequence_search",
]

_COARSE, _LEAF = 0, 1


@dataclasses.dataclass(frozen=True)
class AnytimeStats:
    """Exploration accounting for one query (or a batch, summed).

    ``residual_lb`` is the rooted frontier minimum at exit (``inf`` when
    exploration completed: the answer is exact); the per-answer error
    bounds on the result derive from it.  ``refined`` counts windows
    pushed through the stage cascade (the budget spent); ``ref_dtw`` the
    representative DTWs of the seeding step.
    """

    n_windows: int = 0
    refined: int = 0
    budget: int | None = None
    clusters_total: int = 0
    clusters_explored: int = 0
    nodes_expanded: int = 0
    frontier: int = 0
    residual_lb: float = math.inf
    ref_dtw: int = 0
    full_dtw: int = 0
    stage_names: tuple[str, ...] = ()
    stage_pruned: tuple[int, ...] = ()

    @property
    def pruned_by(self) -> dict[str, int]:
        return dict(zip(self.stage_names, self.stage_pruned))

    @property
    def pruning_ratio(self) -> float:
        """Fraction of the window bank never paid a full DP."""
        if self.n_windows == 0:
            return 0.0
        return 1.0 - (self.full_dtw + self.ref_dtw) / self.n_windows


@dataclasses.dataclass(frozen=True)
class AnytimeResult:
    """Best-so-far top-k with per-answer error bounds (one query).

    ``indices`` are global window ids of the queried tier (row ids for
    the whole-row length); ``row_ids``/``starts`` give provenance.
    ``error_bounds[j]`` soundly upper-bounds ``distances[j] - t_j`` where
    ``t_j`` is the true j-th distance; all zeros means exact.
    """

    distances: np.ndarray  # (k,) rooted, ascending
    indices: np.ndarray  # (k,) int64 global window ids; -1 = no answer yet
    row_ids: np.ndarray  # (k,) int64
    starts: np.ndarray  # (k,) int64
    error_bounds: np.ndarray  # (k,) float64, 0 = provably exact
    stats: AnytimeStats

    @property
    def distance(self) -> float:
        return float(self.distances[0])

    @property
    def index(self) -> int:
        return int(self.indices[0])

    @property
    def error_bound(self) -> float:
        return float(np.max(self.error_bounds))


@dataclasses.dataclass(frozen=True)
class AnytimeBatchResult:
    """Per-query anytime results stacked (Q, k); stats summed."""

    distances: np.ndarray
    indices: np.ndarray
    row_ids: np.ndarray
    starts: np.ndarray
    error_bounds: np.ndarray
    stats: AnytimeStats
    per_query: tuple[AnytimeResult, ...]

    def __getitem__(self, i: int) -> AnytimeResult:
        return self.per_query[i]

    def __len__(self) -> int:
        return len(self.per_query)


def _pow2(n: int) -> int:
    return 1 << max(3, (n - 1).bit_length())


def _agg_stats(per: list[AnytimeStats]) -> AnytimeStats:
    if len(per) == 1:
        return per[0]
    names = per[0].stage_names
    return AnytimeStats(
        n_windows=sum(s.n_windows for s in per),
        refined=sum(s.refined for s in per),
        budget=per[0].budget,
        clusters_total=sum(s.clusters_total for s in per),
        clusters_explored=sum(s.clusters_explored for s in per),
        nodes_expanded=sum(s.nodes_expanded for s in per),
        frontier=sum(s.frontier for s in per),
        residual_lb=max(s.residual_lb for s in per),
        ref_dtw=sum(s.ref_dtw for s in per),
        full_dtw=sum(s.full_dtw for s in per),
        stage_names=names,
        stage_pruned=tuple(
            sum(s.stage_pruned[i] for s in per) for i in range(len(names))
        ),
    )


def _batch(per: list[AnytimeResult]) -> AnytimeBatchResult:
    return AnytimeBatchResult(
        distances=np.stack([r.distances for r in per]),
        indices=np.stack([r.indices for r in per]),
        row_ids=np.stack([r.row_ids for r in per]),
        starts=np.stack([r.starts for r in per]),
        error_bounds=np.stack([r.error_bounds for r in per]),
        stats=_agg_stats([r.stats for r in per]),
        per_query=tuple(per),
    )


def _tier_tensors(li: LengthIndex) -> dict[str, torch.Tensor]:
    """The tree arrays the seeding step reads, on the bank's device: the
    boxes, the radii and the representative windows, uploaded at the
    tier's first query and kept in ``li.cache``."""
    if not li.cache:
        t, dev = li.tree, li.wins.device
        li.cache.update(
            {f: torch.as_tensor(getattr(t, f), device=dev)
             for f in ("cmin0", "cmax0", "cmin1", "cmax1", "radii_w", "min_radii_wide")},
            reps=li.wins.index_select(0, torch.as_tensor(t.rep_gid, device=dev)),
        )
    return li.cache


class _Pool:
    """Top-k pool under the canonical ``(powered distance, gid)`` order.

    The lexicographic tie-break reproduces the block sweep's implicit
    earlier-id-wins behaviour, making the pool independent of the order
    blocks were refined in: the crux of the bit-match guarantee.
    """

    def __init__(self, k: int, dtype):
        self.k = k
        self.d = np.empty(0, dtype=dtype)
        self.g = np.empty(0, dtype=np.int64)

    def merge(self, d: np.ndarray, g: np.ndarray) -> None:
        d = np.concatenate([self.d, d])
        g = np.concatenate([self.g, g])
        keep = np.lexsort((g, d))[: self.k]
        self.d, self.g = d[keep], g[keep]

    @property
    def kth(self) -> float:
        """Current kth powered distance (BIG while the pool is short)."""
        if self.d.shape[0] < self.k:
            return self.d.dtype.type(BIG)
        return self.d[-1]

    @property
    def gate(self):
        """Strict pruning gate: ``nextafter(kth)``; a lane is culled only
        when its bound provably *exceeds* kth, so ties survive."""
        return np.nextafter(self.kth, self.d.dtype.type(np.inf))


class _Refiner:
    """Shared refinement state for one query against one tier: the query
    and its envelope on the bank's device (cast to the bank's dtype), the
    pool and the counters on the host."""

    def __init__(self, q: np.ndarray, li: LengthIndex, p: PNorm, method: Method, k: int):
        self.li, self.p, self.method, self.k = li, p, method, k
        wins = li.wins
        self.qs = torch.as_tensor(np.asarray(q)[None, :], dtype=wins.dtype, device=wins.device)
        self.u, self.l = envelope_op(self.qs, li.w)
        self.pool = _Pool(k, torch.empty((), dtype=wins.dtype).numpy().dtype)
        self.names = lb_stage_names(method)
        self.stage_pruned = np.zeros(len(self.names), np.int64)
        self.full_dtw = 0
        self.refined = 0

    def refine(self, gids: np.ndarray) -> None:
        """Run the member windows through the stage cascade and merge."""
        n = gids.shape[0]
        if n == 0:
            return
        wins = self.li.wins
        pad = _pow2(n)
        blk = wins.new_zeros((pad, self.li.m))
        blk[:n] = wins.index_select(0, torch.as_tensor(gids, device=wins.device))
        mask0 = torch.zeros((1, pad), dtype=torch.bool, device=wins.device)
        mask0[0, :n] = True
        bound = torch.tensor([self.pool.gate], dtype=wins.dtype, device=wins.device)
        # through the module attribute: a caller may wrap the pipeline
        st = pipeline.run_block_stages(
            self.qs, self.u, self.l, self.li.w, self.p, self.method, blk, bound, mask0
        )
        masks = torch.stack(st.masks)[:, 0].cpu().numpy()
        for s in range(len(masks) - 1):
            self.stage_pruned[s] += int((masks[s] & ~masks[s + 1]).sum())
        self.full_dtw += int(masks[-1].sum())
        self.refined += n
        self.pool.merge(st.d[0, :n].cpu().numpy(), gids.astype(np.int64))

    def result(self, residual_pow: float, stats_extra: dict) -> AnytimeResult:
        k, li, dt = self.k, self.li, self.pool.d.dtype
        n_got = self.pool.d.shape[0]
        d = np.full(k, dt.type(BIG))
        g = np.full(k, -1, np.int64)
        d[:n_got], g[:n_got] = self.pool.d, self.pool.g
        # rooted on the bank's device as the drivers root theirs (torch's
        # float32 sqrt on the CPU is not numpy's); the residual rides along
        rooted = finish_cost(
            torch.as_tensor(np.append(d, dt.type(residual_pow)), device=li.wins.device),
            self.p,
        ).cpu().numpy()
        distances, residual = rooted[:k], float(rooted[k])
        err = np.maximum(0.0, distances.astype(np.float64) - residual)
        err[n_got:] = np.inf
        valid = g >= 0
        stats = AnytimeStats(
            n_windows=li.n_windows,
            refined=self.refined,
            clusters_total=li.tree.n_leaves,
            residual_lb=residual,
            full_dtw=self.full_dtw,
            stage_names=self.names,
            stage_pruned=tuple(int(x) for x in self.stage_pruned),
            **stats_extra,
        )
        return AnytimeResult(
            distances=distances,
            indices=g,
            row_ids=np.where(valid, li.row_ids[np.where(valid, g, 0)], -1),
            starts=np.where(valid, li.starts[np.where(valid, g, 0)], -1),
            error_bounds=err,
            stats=stats,
        )


def _search_one(
    q: np.ndarray,
    li: LengthIndex,
    p: PNorm,
    method: Method,
    k: int,
    budget: int | None,
) -> AnytimeResult:
    """Best-first anytime exploration for a single query."""
    tree = li.tree
    ref = _Refiner(q, li, p, method, k)
    tt = _tier_tensors(li)
    u, l = ref.u[0], ref.l[0]

    # --- seed: per-cluster LBs + exact refinement of the representatives
    box0 = lb_box_powered(tt["cmin0"], tt["cmax0"], u, l, p).cpu().numpy()
    box1 = (
        lb_box_powered(tt["cmin1"], tt["cmax1"], u, l, p).cpu().numpy()
        if tree.n_leaves
        else np.empty(0, np.float32)
    )
    d_reps_w = finish_cost(dtw_qbatch_op(ref.qs, tt["reps"], li.w, p), p)[0]
    d_reps_wide = finish_cost(
        dtw_qbatch_op(ref.qs, tt["reps"], wide_band(li.w, li.m), p), p
    )[0]
    tri0 = powered(
        lb_triangle_clusters(
            d_reps_w,
            d_reps_wide,
            tt["radii_w"],
            tt["min_radii_wide"],
            theorem1_bound(li.m, li.w, p),
        ),
        p,
    ).cpu().numpy()
    lb0 = np.maximum(box0, np.nan_to_num(tri0, nan=0.0))
    ref.refine(tree.rep_gid)
    ref_dtw = 2 * tree.n_coarse

    # --- explore: min-heap of (powered lb, insertion seq, kind, index)
    heap: list[tuple[float, int, int, int]] = []
    seq = 0
    for c in range(tree.n_coarse):
        if tree.leaf_start[c + 1] > tree.leaf_start[c]:
            heapq.heappush(heap, (float(lb0[c]), seq, _COARSE, c))
            seq += 1
    explored = expanded = 0
    residual_pow = math.inf
    while heap:
        if budget is not None and ref.refined >= budget:
            residual_pow = heap[0][0]
            break
        lb, _, kind, idx = heapq.heappop(heap)
        if not (lb < float(ref.pool.gate)):  # frontier min > kth: exact
            residual_pow = lb
            heapq.heappush(heap, (lb, -1, kind, idx))  # keep frontier count
            break
        if kind == _COARSE:
            expanded += 1
            for leaf in tree.coarse_leaves(idx):
                heapq.heappush(heap, (max(float(box1[leaf]), lb), seq, _LEAF, leaf))
                seq += 1
        else:
            explored += 1
            ref.refine(tree.leaf_members(idx))
    return ref.result(
        residual_pow,
        dict(
            budget=budget,
            clusters_explored=explored,
            nodes_expanded=expanded,
            frontier=len(heap),
            ref_dtw=ref_dtw,
        ),
    )


def anytime_search(
    queries: np.ndarray,
    index: AnytimeIndex,
    *,
    k: int,
    method: Method,
    budget: int | None = None,
) -> AnytimeBatchResult:
    """Budgeted anytime top-k over the tier matching the query length.

    ``budget`` caps the number of windows refined per query (``None`` =
    unlimited; the coarse representatives are always refined, so the
    effective floor is the tier's cluster count).  Exhausted exploration
    (frontier empty or provably dominated) returns the exact answer with
    all error bounds 0.
    """
    qs = np.atleast_2d(np.asarray(queries))
    li = index.tier(qs.shape[-1])
    if budget is not None:
        budget = int(budget)
        if budget < 1:
            raise ValueError(
                f"budget={budget} must be >= 1 refined windows per query "
                f"(or None for unlimited)"
            )
    return _batch([_search_one(q, li, index.p, method, k, budget) for q in qs])


def exact_subsequence_search(
    queries: np.ndarray,
    index: AnytimeIndex,
    *,
    k: int,
    method: Method,
    block: int = 64,
) -> AnytimeBatchResult:
    """Exact top-k over a window bank: the plain gid-order block sweep.

    The reference the anytime explorer must converge to for subsequence
    (``m < n``) queries: same pipeline, same strict gate, same canonical
    ``(distance, gid)`` pool, no tree.  Error bounds are 0 by
    construction.
    """
    qs = np.atleast_2d(np.asarray(queries))
    li = index.tier(qs.shape[-1])
    block = max(8, int(block))
    per = []
    for q in qs:
        ref = _Refiner(q, li, index.p, method, k)
        for s in range(0, li.n_windows, block):
            ref.refine(np.arange(s, min(s + block, li.n_windows)))
        per.append(
            ref.result(
                math.inf,
                dict(
                    budget=None,
                    clusters_explored=0,
                    nodes_expanded=0,
                    frontier=0,
                    ref_dtw=0,
                ),
            )
        )
    return _batch(per)
