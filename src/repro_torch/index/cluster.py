"""BrainEx/TC-DTW-style clustering for cluster-granularity pruning (port
of ``repro.index.cluster``, a copy: numpy bookkeeping).

BrainEx (Genex) groups sequences around representatives and prunes whole
groups by comparing the query against the representative only; TC-DTW
adds the triangle inequality on top.  We follow the same recipe in the
shape that fits a precomputed distance matrix:

* representatives = a prefix of the farthest-first reference traversal
  (any FFT prefix is a k-center cover, so radii stay small);
* every series joins its nearest representative;
* each cluster stores its max and min member-to-representative distance
  (``radii`` / ``min_radii``), which is exactly what the cluster-level
  triangle bound (triangle_lb.lb_triangle_clusters) consumes.

The assignment is a pure argmin over rows the reference selection
already computed — clustering adds zero DTW evaluations at build time.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Clustering:
    """Cluster structure over an N-series database with C representatives.

    ``radii`` come from the band-w matrix (they relax pair-bound side A);
    ``min_radii_wide`` from the band-2w matrix (side B) — the two sides
    of the banded triangle inequality consume different bands, see
    triangle_lb's module docstring.
    """

    rep_rows: np.ndarray  # (C,) rows of d_ref_db acting as representatives
    assign: np.ndarray  # (N,) cluster id in [0, C)
    radii: np.ndarray  # (C,) max DTW^w(member, rep) per cluster
    min_radii_wide: np.ndarray  # (C,) min DTW^{2w}(member, rep) per cluster
    d_rep_member: np.ndarray  # (N,) DTW^w(series, its rep)

    @property
    def n_clusters(self) -> int:
        return int(self.rep_rows.shape[0])

    def members(self, cid: int) -> np.ndarray:
        return np.nonzero(self.assign == cid)[0]


def cluster_from_distances(
    d_ref_db: np.ndarray,
    n_clusters: int | None = None,
    d_ref_db_wide: np.ndarray | None = None,
    exclude_cols: np.ndarray | None = None,
) -> Clustering:
    """Build clusters from the (R, N) band-w reference-distance matrix.

    ``n_clusters`` defaults to all R references; a smaller value uses the
    first ``n_clusters`` rows (the FFT prefix).  ``d_ref_db_wide`` (the
    band-2w matrix) feeds the side-B cluster bound; without it that side
    is disabled (min_radii_wide = 0 never fires, which is conservative).

    ``exclude_cols`` names series the query path never reaches through
    the cluster bound (the references — stage 0 evaluates them exactly),
    so the side-B minimum may skip them.  Each representative is itself
    a member of its cluster at wide-distance 0; without the exclusion
    min_radii_wide would be identically 0 and side B could never fire.
    """
    n_refs, n_db = d_ref_db.shape
    c = n_refs if n_clusters is None else int(n_clusters)
    if not 0 < c <= n_refs:
        raise ValueError(f"n_clusters must be in [1, {n_refs}], got {c}")
    d = np.asarray(d_ref_db[:c], np.float64)
    assign = np.argmin(d, axis=0)
    cols = np.arange(n_db)
    d_rep_member = d[assign, cols]
    wide = (
        np.asarray(d_ref_db_wide[:c], np.float64)[assign, cols]
        if d_ref_db_wide is not None
        else None
    )
    covered = np.ones(n_db, bool)
    if exclude_cols is not None:
        covered[np.asarray(exclude_cols)] = False
    radii = np.zeros(c)
    min_radii_wide = np.zeros(c)
    for cid in range(c):
        mask = assign == cid
        if mask.any():
            radii[cid] = d_rep_member[mask].max()
            if wide is not None and (mask & covered).any():
                min_radii_wide[cid] = wide[mask & covered].min()
    return Clustering(
        rep_rows=np.arange(c, dtype=np.int64),
        assign=assign.astype(np.int64),
        radii=radii,
        min_radii_wide=min_radii_wide,
        d_rep_member=d_rep_member,
    )
