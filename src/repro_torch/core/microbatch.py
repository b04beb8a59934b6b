"""Query-queue microbatching front end (port of ``repro.core.microbatch``).

Turns a batched search entry point (``nn_search_scan`` /
``nn_search_host`` with a ``(Q, n)`` query) into a queue-drain loop:
queries are grouped into fixed-size microbatches, each batch rides one
query-major sweep, and per-query results stream back in submission
order.  numpy only.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

from repro_torch.core.cascade import BatchSearchResult, SearchResult


def pad_rows(
    rows: Sequence[np.ndarray] | np.ndarray, batch: int
) -> tuple[np.ndarray, int]:
    """Stack (n,) rows into one fixed-shape (batch, n) block.

    The microbatching primitive shared by the queue drain below and the
    serving engine's coalescer (``repro.serve``): a ragged group is
    padded by repeating its last row, so every dispatch sees the same
    (batch, n) shape (one jit specialisation) and pad lanes are plain
    duplicate work whose results the caller drops.  Returns
    ``(block, n_valid)`` with ``n_valid`` the number of real leading
    rows.  Multivariate (n, d) queries stack the same way into a
    (batch, n, d) block.
    """
    block = np.asarray(rows)
    if block.ndim not in (2, 3):
        raise ValueError(
            f"expected a group of (n,) rows or (n, d) multivariate "
            f"queries, got shape {block.shape}"
        )
    n_valid = block.shape[0]
    if not 1 <= n_valid <= batch:
        raise ValueError(f"got {n_valid} rows for a batch of {batch}")
    if n_valid < batch:
        pad = np.repeat(block[-1:], batch - n_valid, axis=0)
        block = np.concatenate([block, pad], axis=0)
    return block, n_valid


def iter_query_batches(
    queries: Iterable[np.ndarray] | np.ndarray, batch: int
) -> Iterator[tuple[np.ndarray, int]]:
    """Group a query stream into (batch, n) microbatches.

    ``queries`` may be a (N, n) array or any iterable of (n,) series —
    including a live producer: batches are formed as soon as ``batch``
    queries (or the end of the stream) arrive, nothing is materialized
    up front.  Yields ``(block, n_valid)``: a ragged batch is padded by
    repeating its last query so every dispatch sees the same (batch, n)
    shape (one jit specialisation); ``n_valid`` tells the caller how
    many leading rows are real.
    """
    if batch <= 0:
        raise ValueError(f"query batch must be positive, got {batch}")
    if isinstance(queries, np.ndarray) and queries.ndim not in (2, 3):
        raise ValueError(
            f"expected an (N, n) or multivariate (N, n, d) query array, "
            f"got {queries.shape}"
        )
    it = iter(queries)
    while True:
        block_rows = list(itertools.islice(it, batch))
        if not block_rows:
            return
        # ragged tail: pad, results are dropped later
        yield pad_rows(block_rows, batch)


def drain_queries(
    queries: Iterable[np.ndarray] | np.ndarray,
    search_batch_fn: Callable[[np.ndarray], BatchSearchResult],
    batch: int,
) -> Iterator[SearchResult]:
    """Queue-drain front end: run queries through a batched search fn.

    ``search_batch_fn`` takes a (batch, n) block and returns a
    ``BatchSearchResult`` (e.g. ``sharded_nn_search`` / ``nn_search_scan``
    / ``nn_search_indexed`` with a 2-D query).  Per-query results come
    back in submission order, so callers can zip them against their
    queue; pad lanes of the ragged final batch are never yielded.  The
    queue may be a live iterator: each microbatch is served as soon as
    it fills (or the stream ends), so an open-ended producer gets
    results back while it keeps submitting.
    """
    for block, n_valid in iter_query_batches(queries, batch):
        res = search_batch_fn(block)
        for i in range(n_valid):
            yield res[i]
