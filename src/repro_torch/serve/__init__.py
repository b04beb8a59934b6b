"""Multi-tenant query serving over one Database session (port of
``repro.serve``; DESIGN.md §3.8).

    from repro_torch.api import Database, SearchConfig
    from repro_torch.serve import QueryEngine

    db = Database.build(data, SearchConfig(p="inf"))
    with QueryEngine(db, max_batch=8, max_wait_ms=2.0) as engine:
        futures = [engine.submit(q, tenant="web") for q in queries]
        answers = [f.result() for f in futures]   # bit-match db.search
        sess = engine.open_stream(threshold=3.0)  # same artifacts
        print(engine.stats())                     # occupancy, hits, qps

The engine is the serving layer the paper's bounds exist for: admission
with backpressure and deadlines, round-robin microbatch coalescing onto
the query-major drivers, an LRU answer cache over z-normed query
digests, and concurrent streaming sessions — all over one set of
build-once artifacts on the session's device, adding zero numeric
surface (every answer is bit-identical to the direct ``Database`` call).
"""

from repro_torch.serve.cache import AnswerCache, query_digest, stable_digest
from repro_torch.serve.engine import (
    AdmissionFull,
    Answer,
    DeadlineExceeded,
    EngineStats,
    QueryEngine,
    StreamSession,
)

__all__ = [
    "AdmissionFull",
    "Answer",
    "AnswerCache",
    "DeadlineExceeded",
    "EngineStats",
    "QueryEngine",
    "StreamSession",
    "query_digest",
    "stable_digest",
]
