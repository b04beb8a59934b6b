"""Stage-0 pruning subsystem: the triangle-inequality reference index
(port of ``repro.index``).

The paper's Theorem 1 gives the tight weak triangle inequality

    DTW_p(x, z) <= c * (DTW_p(x, y) + DTW_p(y, z)),   c = min(2w+1, n)^(1/p)

(c = 1 for p = inf, where DTW_inf is a true metric).  This package turns
it into a pruning stage that runs before the LB_Keogh/LB_Improved
cascade:

* ``references``  — maxmin (farthest-first) reference selection under DTW;
* ``cluster``     — cluster assignments with per-cluster representatives
  and radii;
* ``triangle_lb`` — the stage-0 bound LB_tri and its cluster form;
* ``build``       — the index build (``TriangleIndex``);
* ``store``       — save/load, ``.npz`` files interchangeable with
  ``repro.index.store``.

Query-time entry point: ``repro_torch.core.cascade.nn_search_indexed``.
"""

from repro_torch.index.build import TriangleIndex, build_index
from repro_torch.index.cluster import Clustering, cluster_from_distances
from repro_torch.index.references import select_references
from repro_torch.index.store import load_index, save_index
from repro_torch.index.triangle_lb import (
    lb_triangle_batch,
    lb_triangle_clusters,
    lb_triangle_pair,
    wide_band,
)

__all__ = [
    "TriangleIndex",
    "build_index",
    "Clustering",
    "cluster_from_distances",
    "select_references",
    "save_index",
    "load_index",
    "lb_triangle_pair",
    "lb_triangle_batch",
    "lb_triangle_clusters",
    "wide_band",
]
