"""Index build pipeline: references + distances + clusters -> TriangleIndex
(port of ``repro.index.build``).

Build cost is 2R banded-DTW sweeps of one row against the database, on
the database's device (the DP kernel K5 on CUDA): one at band w and one
at the composed band 2w, because the two sides of the banded triangle
inequality consume different bands (``triangle_lb``).  Everything
downstream of the distance matrices is numpy bookkeeping.  The index is
tied to the (w, p) it was built with — Theorem 1's constant depends on
both — and ``validate`` refuses to serve queries under other parameters.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core.dtw import PNorm
from repro_torch.core.metrics import theorem1_bound
from repro_torch.index.cluster import Clustering, cluster_from_distances
from repro_torch.index.references import _ref_row, select_references
from repro_torch.index.triangle_lb import wide_band
from repro_torch.kernels.common import resolve_device


def db_digest(db) -> str:
    """Stable fingerprint of the database contents (not just its shape);
    a tensor is read back from its device."""
    if isinstance(db, torch.Tensor):
        db = db.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(db, np.float32))
    return hashlib.sha1(arr.tobytes()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class TriangleIndex:
    """Prebuilt stage-0 pruning structure for one database.

    All distances are rooted DTW_p values (the triangle inequality lives
    in distance space); the cascade converts bounds to its powered
    threshold domain at query time.
    """

    ref_idx: np.ndarray  # (R,) database indices of the references
    ref_series: np.ndarray  # (R, d*n) the reference series (flattened)
    d_ref_db: np.ndarray  # (R, N) DTW^w(reference, series)
    d_ref_db_wide: np.ndarray  # (R, N) DTW^{2w}(reference, series)
    clustering: Clustering  # reps are the first C references
    w: int
    p: float  # np.inf for p = inf
    n: int  # per-channel series length
    n_db: int
    digest: str = ""  # db_digest of the database the index was built on
    d: int = 1  # channel count; distances are dependent mv DTW when > 1

    @property
    def n_refs(self) -> int:
        return int(self.ref_idx.shape[0])

    @property
    def n_clusters(self) -> int:
        return self.clustering.n_clusters

    @property
    def constant(self) -> float:
        """Theorem 1's c = min(2w+1, n)^(1/p)."""
        return theorem1_bound(self.n, self.w, self.p)

    @property
    def w_wide(self) -> int:
        """Band of the composed warping path: min(2w, n-1)."""
        return wide_band(self.w, self.n)

    @property
    def rep_idx(self) -> np.ndarray:
        """Database indices of the cluster representatives (FFT prefix)."""
        return self.ref_idx[self.clustering.rep_rows]

    def validate(self, n_db: int, n: int, w: int, p: PNorm, d: int = 1) -> None:
        got = (n_db, n, int(w), float(p), int(d))
        want = (self.n_db, self.n, self.w, float(self.p), self.d)
        if got != want:
            raise ValueError(
                f"index built for (n_db, n, w, p, d)={want}, query asks {got}"
            )

    def validate_data(self, db) -> None:
        """Check the index belongs to *this* database, not just its shape.

        A stale index over a different database would produce invalid
        LB_tri bounds and silently prune true neighbours — fail loudly
        instead.  O(N*n) hash; call once per load, not per query.
        """
        got = db_digest(db)
        if self.digest and got != self.digest:
            raise ValueError(
                f"index was built on a different database "
                f"(digest {self.digest}, got {got})"
            )

    def device_arrays(self, device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
        """The build-time constants as tensors on ``device``, uploaded
        once per (device, dtype) and cached on the index.  ``dtype`` is
        the session's: the radii (float64 on the host) take it, as the
        reference's device arrays do (float32 without x64); the reference
        series keep their dtype and the distance matrices stay float32,
        so a float64 session promotes them against its query distances."""
        cache = self.__dict__.setdefault("_device_arrays", {})
        key = (torch.device(device), dtype)
        if key not in cache:
            cl = self.clustering

            def up(a):
                return torch.as_tensor(np.asarray(a), device=key[0])

            cache[key] = {
                "ref_series": up(self.ref_series),
                "d_ref_db": up(self.d_ref_db),
                "d_ref_db_wide": up(self.d_ref_db_wide),
                "radii": up(cl.radii).to(dtype),
                "min_radii_wide": up(cl.min_radii_wide).to(dtype),
            }
        return cache[key]


def build_index(
    db, w: int, p: PNorm = 1, n_refs: int = 8, n_clusters: int | None = None,
    strategy: str = "maxmin", seed: int = 0, d: int = 1, device=None,
) -> TriangleIndex:
    """Build a triangle-inequality reference index over ``db``, a numpy
    array or a tensor, on its device (or ``device``): (N, n) univariate,
    or (N, d*n) channel-major flattened with ``d > 1``, whose distances
    are then dependent mv DTW with n the per-channel length."""
    if db.ndim != 2:
        raise ValueError(f"db must be (N, n) or (N, d*n), got {tuple(db.shape)}")
    d = int(d)
    dev = resolve_device(device, like=db)
    db_t = torch.as_tensor(db, device=dev).contiguous()
    n_db, n_flat = db_t.shape
    if d < 1 or n_flat % d:
        raise ValueError(f"flat length {n_flat} not a multiple of d={d}")
    n = n_flat // d
    w = int(min(int(w), n - 1))
    rng = np.random.default_rng(seed)
    ref_idx, d_ref_db = select_references(db_t, n_refs, w, p, strategy=strategy, rng=rng,
                                          d=d)
    # second sweep at the composed band 2w (side A/B of the bound)
    w2 = wide_band(w, n)
    d_ref_db_wide = np.stack([_ref_row(db_t, int(i), w2, p, d) for i in ref_idx])
    # references are evaluated exactly at query time, so the cluster
    # side-B minimum may skip them — without the exclusion every
    # representative's self-distance of 0 would pin min_radii_wide to 0
    clustering = cluster_from_distances(
        d_ref_db, n_clusters, d_ref_db_wide, exclude_cols=ref_idx
    )
    return TriangleIndex(
        ref_idx=ref_idx,
        ref_series=db_t[torch.as_tensor(ref_idx, device=dev)].cpu().numpy(),
        d_ref_db=np.asarray(d_ref_db, np.float32),
        d_ref_db_wide=np.asarray(d_ref_db_wide, np.float32),
        clustering=clustering,
        w=w,
        p=float(p),
        n=n,
        n_db=n_db,
        digest=db_digest(db),
        d=d,
    )
