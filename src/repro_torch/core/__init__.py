"""Core of the paper: DTW_p, envelopes, the bound family, cascade search
(the names ``repro.core`` exports, but ``envelope``: here that name stays
the ``repro_torch.core.envelope`` module, which callers import)."""

from repro_torch.core.dtw import (
    BIG,
    dtw_banded,
    dtw_banded_diag,
    dtw_batch,
    dtw_qbatch,
    dtw_reference,
)
from repro_torch.core.envelope import envelope_batch, envelope_naive
from repro_torch.core.lb import (
    lb_improved,
    lb_improved_powered,
    lb_improved_powered_batch,
    lb_improved_powered_qbatch,
    lb_keogh,
    lb_keogh_powered,
    lb_keogh_powered_batch,
    lb_keogh_powered_qbatch,
    project,
)
from repro_torch.core.cascade import (
    BatchSearchResult,
    SearchResult,
    SearchStats,
    nn_search_host,
    nn_search_indexed,
    nn_search_scan,
)
from repro_torch.core.pipeline import (
    PIPELINES,
    STAGES,
    BlockStages,
    PipeContext,
    Stage,
    run_block_stages,
)
from repro_torch.core.classify import classification_accuracy, nn_classify
from repro_torch.core.microbatch import drain_queries, iter_query_batches
from repro_torch.core.metrics import (
    theorem1_bound,
    triangle_lower_bound,
    triangle_ratio,
    violation_fraction,
)

__all__ = [
    "BIG",
    "dtw_banded",
    "dtw_banded_diag",
    "dtw_batch",
    "dtw_qbatch",
    "dtw_reference",
    "envelope_batch",
    "envelope_naive",
    "lb_keogh",
    "lb_keogh_powered",
    "lb_keogh_powered_batch",
    "lb_keogh_powered_qbatch",
    "lb_improved",
    "lb_improved_powered",
    "lb_improved_powered_batch",
    "lb_improved_powered_qbatch",
    "project",
    "BatchSearchResult",
    "SearchResult",
    "SearchStats",
    "BlockStages",
    "PipeContext",
    "Stage",
    "STAGES",
    "PIPELINES",
    "run_block_stages",
    "nn_search_scan",
    "nn_search_host",
    "nn_search_indexed",
    "drain_queries",
    "iter_query_batches",
    "nn_classify",
    "classification_accuracy",
    "triangle_ratio",
    "theorem1_bound",
    "triangle_lower_bound",
    "violation_fraction",
]
