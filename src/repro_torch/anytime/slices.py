"""Length-of-interest subsequence slicing + PAA sketches (port of
``repro.anytime.slices``).

The anytime tier's build phase turns the raw database into a flat bank
of candidate *windows* at each length of interest: every window of
length ``m`` (stride ``hop``) of every row, optionally z-normalised per
window.  This reuses the ``stream`` package's window machinery
(``sliding_window_view`` slicing, float64 prefix sums for the per-window
mean/std, the same ``znorm_windows`` arithmetic), so a stored window is
bit-identical to the one the streaming scanner would score.

Each window also gets a PAA sketch (Piecewise Aggregate Approximation,
Keogh et al. 2001): segment means at a fixed low dimension.  The sketch
is the *clustering* feature only; bounds and refinement always run on
the full-resolution windows.

Both stay numpy on the host, in the reference's order: the window bank's
bits and the sketch's float64 sums decide the cluster tree, which must
come out bit-equal to the reference's.
"""

from __future__ import annotations

import numpy as np

from repro_torch.stream.state import STD_EPS, prefix_sums, window_mean_std_from_prefix
from repro_torch.stream.subsequence import num_windows, znorm_windows

__all__ = ["slice_windows", "paa_sketch"]


def slice_windows(
    rows: np.ndarray,
    m: int,
    hop: int = 1,
    *,
    znorm: bool = False,
    eps: float = STD_EPS,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All length-``m`` windows (stride ``hop``) of every database row.

    Returns ``(wins, row_ids, starts)``: ``wins`` is the flat ``(W, m)``
    window bank in global-id order (row-major, then start offset: the
    exact sweep's tie-break order) and ``row_ids``/``starts`` map each
    global window id back to its ``(row, start)``.  With ``znorm`` each
    window is z-scored on its own from prefix-sum statistics.
    """
    rows = np.asarray(rows)
    if rows.ndim != 2:
        raise ValueError(f"rows must be 2-D (N, n), got shape {rows.shape}")
    n_rows, n = rows.shape
    if not 1 <= m <= n:
        raise ValueError(
            f"window length m={m} must satisfy 1 <= m <= row length {n}"
        )
    hop = int(hop)
    if hop < 1:
        raise ValueError(f"hop={hop} must be >= 1")
    per_row = num_windows(n, m, hop)
    starts_1 = np.arange(per_row, dtype=np.int64) * hop
    wins = np.empty((n_rows * per_row, m), dtype=dtype)
    for r in range(n_rows):
        w = np.lib.stride_tricks.sliding_window_view(rows[r], m)[::hop]
        if znorm:
            c1, c2 = prefix_sums(rows[r])
            mean, std = window_mean_std_from_prefix(c1, c2, starts_1, m, eps)
            w = znorm_windows(w, mean, std)
        wins[r * per_row : (r + 1) * per_row] = w
    row_ids = np.repeat(np.arange(n_rows, dtype=np.int64), per_row)
    starts = np.tile(starts_1, n_rows)
    return wins, row_ids, starts


def paa_sketch(wins: np.ndarray, dim: int) -> np.ndarray:
    """PAA segment means: ``(W, m) -> (W, dim)`` float32 sketches.

    Segment boundaries follow ``np.linspace`` so ragged ``m % dim``
    remainders spread evenly; ``dim >= m`` is the identity.
    """
    wins = np.asarray(wins)
    m = wins.shape[-1]
    dim = int(dim)
    if dim < 1:
        raise ValueError(f"paa dim={dim} must be >= 1")
    if dim >= m:
        return np.ascontiguousarray(wins, dtype=np.float32)
    edges = np.linspace(0, m, dim + 1).round().astype(np.int64)
    sums = np.add.reduceat(wins.astype(np.float64), edges[:-1], axis=-1)
    counts = np.diff(edges).astype(np.float64)
    return (sums / counts).astype(np.float32)
