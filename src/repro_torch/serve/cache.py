"""Answer cache: LRU over stable z-normed query digests (port of
``repro.serve.cache``, numpy only; DESIGN.md §3.8).

Repeated and near-duplicate traffic is the serving engine's cheapest
workload: a query that z-normalizes to bytes the session has already
answered needs no cascade at all.  The cache key is a digest of

* the **session fingerprint** (``Database.fingerprint``: config hash +
  resolved band + the database bytes) — a different config or different
  data can never alias an answer, so a stale session's entries are
  unreachable by construction rather than by invalidation;
* the **execution key** (k, stage method, driver override) — per-call
  overrides answer different questions and must miss;
* the **prepared query bytes** (precision-cast, z-normed exactly as the
  driver consumes them) — under z-norm, scaled/shifted copies of one
  query digest identically and share the entry.

Values are the per-query :class:`repro_torch.core.cascade.SearchResult`
the cold path produced, stored as-is: a hit returns the same arrays, so
it is bit-identical to re-running the cascade (pinned by
``tests/test_torch_serve.py``).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np


def stable_digest(*parts) -> str:
    """sha256 over length-prefixed parts (so ("ab","c") != ("a","bc"));
    non-bytes parts are hashed by their ``str`` form."""
    h = hashlib.sha256()
    for p in parts:
        b = p if isinstance(p, bytes) else str(p).encode()
        h.update(str(len(b)).encode())
        h.update(b":")
        h.update(b)
    return h.hexdigest()


def query_digest(fingerprint: str, exec_key: tuple, query: np.ndarray) -> str:
    """The cache key for one prepared (n,) query under one session +
    execution key.  ``query`` must already be what the driver consumes
    (precision-cast, z-normed when the session z-norms)."""
    q = np.ascontiguousarray(query)
    return stable_digest(
        fingerprint, repr(exec_key), str(q.dtype), str(q.shape), q.tobytes()
    )


class AnswerCache:
    """Thread-safe LRU answer store, keyed on :func:`query_digest`.

    ``capacity`` bounds the entry count (0 disables the cache: ``get``
    always misses, ``put`` is a no-op).  ``hits`` / ``misses`` /
    ``evictions`` are cumulative counters the engine folds into its
    stats.  One cache may be shared between engines — keys embed the
    session fingerprint, so sessions can never read each other's
    answers.
    """

    def __init__(self, capacity: int = 256):
        capacity = int(capacity)
        if capacity < 0:
            raise ValueError(f"cache capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict[str, object] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str):
        """The cached answer for ``key`` (refreshed to most-recent), or
        None on a miss."""
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: str, value) -> None:
        """Insert/refresh ``key``; the least-recently-used entry is
        evicted once the capacity is exceeded."""
        if self.capacity == 0:
            return
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
