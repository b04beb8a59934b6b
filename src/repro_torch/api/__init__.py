"""Session API: build-once artifacts, one entry point (port of ``repro.api``).

    from repro_torch.api import Database, SearchConfig

    db = Database.build(data, SearchConfig(k=5))   # on the GPU by default
    print(db.plan(queries).explain())
    res = db.search(queries)
"""

from repro_torch.api.config import SUPPORTED_P, SUPPORTED_PRECISION, SearchConfig
from repro_torch.api.database import BUNDLE_FORMAT_VERSION, Database
from repro_torch.api.planner import DRIVERS, Plan, plan_search

__all__ = [
    "BUNDLE_FORMAT_VERSION",
    "DRIVERS",
    "Database",
    "Plan",
    "SUPPORTED_P",
    "SUPPORTED_PRECISION",
    "SearchConfig",
    "plan_search",
]
