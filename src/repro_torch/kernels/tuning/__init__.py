"""Kernel tuning: schedule spaces, the persisted TuneTable and the timed
sweep (port of ``repro.kernels.tuning``).

The space (:class:`KernelConfig`, :func:`search_space`,
:func:`shape_bucket`), resolution (:class:`TuneTable`,
:func:`active_table`, :func:`install`, :func:`use_table`,
:func:`resolve_config`) and the sweep (:func:`autotune`,
:func:`autotune_session`, :func:`measure_stage_costs`).  Tables are
keyed by device type (``"cuda"``, ``"cpu"``) and share the reference's
JSON, so ``tune_*`` bundle keys load in both packages.
"""

from repro_torch.kernels.tuning.autotune import (
    SESSION_FAMILIES,
    SweepEntry,
    SweepResult,
    autotune,
    autotune_session,
    measure_stage_costs,
)
from repro_torch.kernels.tuning.defaults import DEFAULT_ENTRIES
from repro_torch.kernels.tuning.space import (
    FALLBACK,
    FAMILIES,
    GRID_LAYOUTS,
    KernelConfig,
    search_space,
    shape_bucket,
)
from repro_torch.kernels.tuning.table import (
    TUNE_FORMAT_VERSION,
    TuneTable,
    active_table,
    default_backend,
    install,
    resolve_config,
    use_table,
)

__all__ = [
    "DEFAULT_ENTRIES",
    "FALLBACK",
    "FAMILIES",
    "GRID_LAYOUTS",
    "KernelConfig",
    "SESSION_FAMILIES",
    "SweepEntry",
    "SweepResult",
    "TUNE_FORMAT_VERSION",
    "TuneTable",
    "active_table",
    "autotune",
    "autotune_session",
    "default_backend",
    "install",
    "measure_stage_costs",
    "resolve_config",
    "search_space",
    "shape_bucket",
    "use_table",
]
