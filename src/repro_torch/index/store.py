"""Persistence for prebuilt triangle indexes (port of ``repro.index.store``).

One ``.npz`` file per index: arrays stored natively, scalars in a small
metadata vector.  A format version is embedded so later PRs can migrate
layouts; loading an unknown version fails loudly instead of serving a
corrupt pruning structure (a wrong bound silently breaks exactness).

``index_arrays`` / ``index_from_arrays`` are the flat-dict (de)serialization
halves, shared with the ``repro_torch.api.Database`` bundle, which embeds
the same arrays under an ``idx_`` prefix inside its one-file session
bundle.  The keys and the format version are the reference's, so an
index saved by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

from repro_torch.index.build import TriangleIndex
from repro_torch.index.cluster import Clustering

FORMAT_VERSION = 1


def npz_path(path: str) -> str:
    """Canonical on-disk name: ``.npz`` appended when missing."""
    return path if path.endswith(".npz") else path + ".npz"


def index_arrays(index: TriangleIndex) -> dict[str, np.ndarray]:
    """Flat array dict holding the whole index (scalars in ``meta``)."""
    return {
        "meta": np.asarray(
            [index.w, index.p, index.n, index.n_db, index.d], np.float64
        ),
        "digest": np.str_(index.digest),
        "ref_idx": index.ref_idx,
        "ref_series": index.ref_series,
        "d_ref_db": index.d_ref_db,
        "d_ref_db_wide": index.d_ref_db_wide,
        "rep_rows": index.clustering.rep_rows,
        "assign": index.clustering.assign,
        "radii": index.clustering.radii,
        "min_radii_wide": index.clustering.min_radii_wide,
        "d_rep_member": index.clustering.d_rep_member,
    }


def index_from_arrays(z: Mapping) -> TriangleIndex:
    """Rebuild a ``TriangleIndex`` from the ``index_arrays`` dict (or an
    open ``.npz`` with the same keys)."""
    meta = np.asarray(z["meta"])
    w, p, n, n_db = meta[:4]
    # 5th slot (channel count) appeared with the mv tier; older univariate
    # files carry a 4-slot meta and load as d = 1
    d = int(meta[4]) if meta.shape[0] >= 5 else 1
    clustering = Clustering(
        rep_rows=z["rep_rows"],
        assign=z["assign"],
        radii=z["radii"],
        min_radii_wide=z["min_radii_wide"],
        d_rep_member=z["d_rep_member"],
    )
    return TriangleIndex(
        ref_idx=z["ref_idx"],
        ref_series=z["ref_series"],
        d_ref_db=z["d_ref_db"],
        d_ref_db_wide=z["d_ref_db_wide"],
        clustering=clustering,
        w=int(w),
        p=float(p),
        n=int(n),
        n_db=int(n_db),
        digest=str(z["digest"]) if "digest" in z else "",
        d=d,
    )


def save_index(index: TriangleIndex, path: str) -> str:
    """Write the index to ``path`` (``.npz`` appended if missing)."""
    path = npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        format_version=np.int64(FORMAT_VERSION),
        **index_arrays(index),
    )
    return path


def load_index(path: str) -> TriangleIndex:
    path = npz_path(path)
    with np.load(path) as z:
        version = int(z["format_version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"index format v{version} unsupported (expected v{FORMAT_VERSION})"
            )
        return index_from_arrays(z)
