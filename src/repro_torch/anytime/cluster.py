"""Hierarchical similarity clusters over a window bank (port of
``repro.anytime.cluster``).

Two levels, BrainEx-style:

* **Coarse clusters**: farthest-first traversal on the PAA sketches
  picks ``n_coarse`` representative windows; every other window joins
  its nearest representative.  Each cluster stores its representative's
  global window id, two DTW radii (max rooted ``DTW_p^w`` and min rooted
  ``DTW_p^{2w}`` from the representative to its members) for the
  Theorem 1 triangle bound, and an elementwise bounding *box* over its
  members for the envelope-box bound.
* **Leaves**: each coarse cluster's members are re-split farthest-first
  into leaves of about ``leaf_size`` windows; leaves store only their
  box, which nests inside the parent's.

Representatives are members of no leaf: the query phase refines them
exactly first, so radii and boxes cover the remaining windows only.

The traversal, the assignment and the boxes are the reference's numpy on
the host, in its float32/float64 order, so every index array and box is
bit-equal to ``repro``'s.  The radii are 2·C·W banded DTW sweeps of the
representatives against the window bank on the bank's device:
``kernels/dtw/ops.py::dtw_qbatch_op``, which is the DP kernel (K5) on
CUDA tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dtw import PNorm, finish_cost
from repro_torch.index.triangle_lb import wide_band
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.dtw.ops import dtw_qbatch_op

__all__ = ["ClusterTree", "farthest_first", "build_tree"]

#: windows a radius sweep launch takes (the reference's block shape)
SWEEP_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class ClusterTree:
    """Flat-array two-level cluster tree over ``W`` windows of length m.

    CSR layout: coarse cluster ``c`` owns leaves
    ``leaf_start[c]:leaf_start[c+1]``; leaf ``l`` owns member window ids
    ``members[member_start[l]:member_start[l+1]]``.  Radii are rooted
    distances; boxes are in window space.  All arrays are numpy.
    """

    rep_gid: np.ndarray  # (C,) int64 representative window ids
    radii_w: np.ndarray  # (C,) float32 max DTW^w(rep, member), rooted
    min_radii_wide: np.ndarray  # (C,) float32 min DTW^{2w}(rep, member)
    cmin0: np.ndarray  # (C, m) float32 coarse member boxes
    cmax0: np.ndarray  # (C, m)
    leaf_start: np.ndarray  # (C+1,) int64
    cmin1: np.ndarray  # (L, m) float32 leaf boxes
    cmax1: np.ndarray  # (L, m)
    member_start: np.ndarray  # (L+1,) int64
    members: np.ndarray  # (W - C,) int64 gids grouped by leaf

    @property
    def n_coarse(self) -> int:
        return int(self.rep_gid.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(self.cmin1.shape[0])

    @property
    def n_members(self) -> int:
        return int(self.members.shape[0])

    def leaf_members(self, leaf: int) -> np.ndarray:
        return self.members[self.member_start[leaf] : self.member_start[leaf + 1]]

    def coarse_leaves(self, c: int) -> range:
        return range(int(self.leaf_start[c]), int(self.leaf_start[c + 1]))


def farthest_first(x: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """k-center farthest-first traversal on rows of ``x`` (L2), the
    2-approximation seeding of Gonzalez (1985); ``seed`` picks the start."""
    n = x.shape[0]
    k = int(min(k, n))
    rng = np.random.default_rng(seed)
    first = int(rng.integers(n))
    centers = np.empty(k, dtype=np.int64)
    centers[0] = first
    d = np.linalg.norm(x - x[first], axis=-1)
    for i in range(1, k):
        nxt = int(np.argmax(d))
        centers[i] = nxt
        d = np.minimum(d, np.linalg.norm(x - x[nxt], axis=-1))
    return centers


def _assign(x: np.ndarray, centers: np.ndarray, chunk: int = 4096) -> np.ndarray:
    """Nearest-center label per row of ``x`` (L2 on sketches), chunked."""
    labels = np.empty(x.shape[0], dtype=np.int64)
    cx = x[centers]
    for s in range(0, x.shape[0], chunk):
        blk = x[s : s + chunk]
        d2 = ((blk[:, None, :] - cx[None, :, :]) ** 2).sum(-1)
        labels[s : s + chunk] = np.argmin(d2, axis=-1)
    return labels


def _box(wins: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    if wins.shape[0] == 0:  # empty cluster: +inf/-inf sentinel, never queried
        m = wins.shape[-1]
        return (
            np.full(m, np.inf, dtype=np.float32),
            np.full(m, -np.inf, dtype=np.float32),
        )
    return (
        wins.min(axis=0).astype(np.float32),
        wins.max(axis=0).astype(np.float32),
    )


def _rep_dists(
    reps: torch.Tensor, wins: torch.Tensor, w: int, p: PNorm, chunk: int = SWEEP_CHUNK
) -> np.ndarray:
    """Rooted DTW^w from every representative to every window: (C, W)
    float32, one dense (C, chunk) DP launch a chunk of windows on their
    device, read back once."""
    n_win = wins.shape[0]
    out = torch.empty((reps.shape[0], n_win), dtype=torch.float32, device=wins.device)
    for s in range(0, n_win, chunk):
        acc = dtw_qbatch_op(reps, wins[s : s + chunk], w, p)
        out[:, s : s + chunk] = finish_cost(acc, p)
    return out.cpu().numpy()


def build_tree(
    wins: np.ndarray,
    sketch: np.ndarray,
    *,
    n_coarse: int,
    leaf_size: int,
    w: int,
    p: PNorm,
    radii: bool = True,
    seed: int = 0,
    device=None,
    wins_dev: torch.Tensor | None = None,
) -> ClusterTree:
    """Cluster the window bank ``wins`` (W, m), numpy on the host, into
    the two-level tree.

    The radius sweeps run on ``wins_dev``, the same windows as a tensor,
    when given (no second copy); else ``wins`` is uploaded to ``device``
    (default: the GPU) for them.  ``radii=False`` skips both sweeps
    (vacuous radii: ``+inf`` / ``0`` disable the triangle bound, leaving
    box bounds only), as in the reference.
    """
    n_win, m = wins.shape
    if n_win < 1:
        raise ValueError("cannot cluster an empty window bank")
    n_coarse = int(min(max(1, n_coarse), n_win))
    leaf_size = max(1, int(leaf_size))
    rep_gid = farthest_first(sketch, n_coarse, seed)
    n_coarse = rep_gid.shape[0]
    labels = _assign(sketch, rep_gid)
    labels[rep_gid] = np.arange(n_coarse)  # reps own their cluster
    is_rep = np.zeros(n_win, dtype=bool)
    is_rep[rep_gid] = True

    if radii:
        if wins_dev is None:
            wins_dev = torch.as_tensor(wins, device=resolve_device(device))
        reps = wins_dev[torch.as_tensor(rep_gid, device=wins_dev.device)].contiguous()
        d_w = _rep_dists(reps, wins_dev, w, p)
        d_wide = _rep_dists(reps, wins_dev, wide_band(w, m), p)
    radii_w = np.zeros(n_coarse, dtype=np.float32)
    min_radii_wide = np.full(n_coarse, np.inf, dtype=np.float32)
    if not radii:  # vacuous: side A prunes nothing, side B prunes nothing
        radii_w[:] = np.inf
        min_radii_wide[:] = 0.0

    cmin0 = np.empty((n_coarse, m), dtype=np.float32)
    cmax0 = np.empty((n_coarse, m), dtype=np.float32)
    leaf_start = np.zeros(n_coarse + 1, dtype=np.int64)
    leaf_boxes_min: list[np.ndarray] = []
    leaf_boxes_max: list[np.ndarray] = []
    member_lists: list[np.ndarray] = []
    for c in range(n_coarse):
        mem = np.nonzero((labels == c) & ~is_rep)[0].astype(np.int64)
        cmin0[c], cmax0[c] = _box(wins[mem])
        if radii and mem.shape[0]:
            radii_w[c] = d_w[c, mem].max()
            min_radii_wide[c] = d_wide[c, mem].min()
        if mem.shape[0] == 0:
            leaf_start[c + 1] = leaf_start[c]
            continue
        n_leaves = -(-mem.shape[0] // leaf_size)
        if n_leaves <= 1:
            groups = [mem]
        else:
            sub = farthest_first(sketch[mem], n_leaves, seed + c + 1)
            sub_labels = _assign(sketch[mem], sub)
            groups = [
                mem[sub_labels == i]
                for i in range(sub.shape[0])
                if np.any(sub_labels == i)
            ]
        leaf_start[c + 1] = leaf_start[c] + len(groups)
        for g in groups:
            lo, hi = _box(wins[g])
            leaf_boxes_min.append(lo)
            leaf_boxes_max.append(hi)
            member_lists.append(g)

    member_start = np.zeros(len(member_lists) + 1, dtype=np.int64)
    if member_lists:
        member_start[1:] = np.cumsum([g.shape[0] for g in member_lists])
        members = np.concatenate(member_lists)
        cmin1 = np.stack(leaf_boxes_min)
        cmax1 = np.stack(leaf_boxes_max)
    else:  # every window is a representative
        members = np.empty(0, dtype=np.int64)
        cmin1 = np.empty((0, m), dtype=np.float32)
        cmax1 = np.empty((0, m), dtype=np.float32)
    return ClusterTree(
        rep_gid=rep_gid,
        radii_w=radii_w,
        min_radii_wide=min_radii_wide,
        cmin0=cmin0,
        cmax0=cmax0,
        leaf_start=leaf_start,
        cmin1=cmin1,
        cmax1=cmax1,
        member_start=member_start,
        members=members,
    )
