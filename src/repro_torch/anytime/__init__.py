"""Anytime subsequence-database tier (port of ``repro.anytime``;
DESIGN.md §3.10).

Build phase: slice the database into length-of-interest windows
(``slices``), sketch them with PAA, cluster them hierarchically with
representatives, DTW radii (K5 sweeps on the session's device) and
envelope boxes (``cluster``, ``build``).  The tier rides in the session
bundle under ``any_*`` keys that load in either package.  Query phase:
best-first budgeted exploration returning best-so-far top-k with sound,
tightening error bounds, and the exact sweep over a window bank
(``search``; refinement through the stage pipeline's kernels on the
session's device).

The entry point is the :class:`repro_torch.api.Database` session:
``Database.build(data, config, anytime=...)`` then
``db.search(query, mode="anytime", budget=...)``, or a query of one of
the tier's shorter lengths.
"""

from repro_torch.anytime.build import (
    AnytimeIndex,
    LengthIndex,
    anytime_arrays,
    anytime_from_arrays,
    build_anytime_index,
)
from repro_torch.anytime.cluster import ClusterTree, build_tree, farthest_first
from repro_torch.anytime.search import (
    AnytimeBatchResult,
    AnytimeResult,
    AnytimeStats,
    anytime_search,
    exact_subsequence_search,
)
from repro_torch.anytime.slices import paa_sketch, slice_windows

__all__ = [
    "AnytimeIndex",
    "LengthIndex",
    "AnytimeBatchResult",
    "AnytimeResult",
    "AnytimeStats",
    "ClusterTree",
    "anytime_arrays",
    "anytime_from_arrays",
    "anytime_search",
    "build_anytime_index",
    "build_tree",
    "exact_subsequence_search",
    "farthest_first",
    "paa_sketch",
    "slice_windows",
]
