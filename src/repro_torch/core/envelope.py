"""Warping envelopes U(x), L(x), plain PyTorch (port of ``repro.core.envelope``).

``U(x)_i = max{x_k : |k-i| <= w}`` and ``L(x)_i = min{x_k : |k-i| <= w}``,
by the van Herk–Gil–Werman sliding max/min: pad the series to whole tiles
of W = 2w+1, take per-tile prefix and suffix extrema, combine two lookups
per output.  Max and min are exact, so every method (this one, the CUDA
kernel's, the naive loop) gives the same bits.  ``envelope_naive`` is
the oracle.
"""

from __future__ import annotations

import numpy as np
import torch


def _slide_extreme(x: torch.Tensor, w: int, *, take_max: bool) -> torch.Tensor:
    """Centered sliding max (or min) over the last axis, window [i-w, i+w]."""
    n = x.shape[-1]
    if w <= 0:
        return x
    win = 2 * w + 1
    lead = x.shape[:-1]
    fill = float("-inf") if take_max else float("inf")
    total = n + 2 * w
    nblocks = -(-total // win)
    pad_back = nblocks * win - total
    xp = torch.cat(
        [
            x.new_full(lead + (w,), fill),
            x,
            x.new_full(lead + (w + pad_back,), fill),
        ],
        dim=-1,
    )
    blocks = xp.reshape(lead + (nblocks, win))
    scan = torch.cummax if take_max else torch.cummin
    pref = scan(blocks, dim=-1).values
    suff = scan(blocks.flip(-1), dim=-1).values.flip(-1)
    pref = pref.reshape(lead + (nblocks * win,))
    suff = suff.reshape(lead + (nblocks * win,))
    left = suff[..., :n]  # window over padded array: [i, i + win - 1]
    right = pref[..., win - 1 : win - 1 + n]
    return torch.maximum(left, right) if take_max else torch.minimum(left, right)


def envelope(x: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (U, L), each shaped like ``x`` (1-D)."""
    if x.ndim != 1:
        raise ValueError(f"envelope expects 1-D series, got {tuple(x.shape)}")
    return envelope_batch(x, w)


def envelope_batch(xs: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., n) -> (U, L), each (..., n); w is clamped to n - 1."""
    w = int(min(w, xs.shape[-1] - 1))
    return (
        _slide_extreme(xs, w, take_max=True),
        _slide_extreme(xs, w, take_max=False),
    )


def envelope_naive(x, w: int):
    """Numpy oracle: direct windowed max/min, O(n*w)."""
    x = np.asarray(x)
    n = len(x)
    w = int(min(w, n - 1))
    U = np.empty_like(x)
    L = np.empty_like(x)
    for i in range(n):
        lo, hi = max(0, i - w), min(n, i + w + 1)
        U[i] = x[lo:hi].max()
        L[i] = x[lo:hi].min()
    return U, L
