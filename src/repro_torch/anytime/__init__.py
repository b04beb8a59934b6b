"""Anytime subsequence-database tier, the build side (port of
``repro.anytime``; DESIGN.md §3.10).

Build phase: slice the database into length-of-interest windows
(``slices``), sketch them with PAA, cluster them hierarchically with
representatives, DTW radii (K5 sweeps on the session's device) and
envelope boxes (``cluster``, ``build``).  The tier rides in the session
bundle under ``any_*`` keys that load in either package.

The entry point is the :class:`repro_torch.api.Database` session:
``Database.build(data, config, anytime=...)``.  The query phase
(``mode="anytime"`` and subsequence-length queries) is ROADMAP.md queue
1, item 10b.
"""

from repro_torch.anytime.build import (
    AnytimeIndex,
    LengthIndex,
    anytime_arrays,
    anytime_from_arrays,
    build_anytime_index,
)
from repro_torch.anytime.cluster import ClusterTree, build_tree, farthest_first
from repro_torch.anytime.slices import paa_sketch, slice_windows

__all__ = [
    "AnytimeIndex",
    "LengthIndex",
    "ClusterTree",
    "anytime_arrays",
    "anytime_from_arrays",
    "build_anytime_index",
    "build_tree",
    "farthest_first",
    "paa_sketch",
    "slice_windows",
]
