"""Channel-major flattening: the (n, d) <-> (d*n,) storage convention
(port of ``repro.mv.layout``).

A multivariate series enters the public API channel-*minor* — shape
``(..., n, d)``, one time step per row, matching how sensor frames
arrive — and is stored channel-*major*: the d channels transposed into
contiguous length-n segments and flattened to one ``(..., d*n)`` row.

* **segment = series.**  Channel ch of a flattened row is the ordinary
  univariate series ``row[ch*n : (ch+1)*n]``, so every per-channel
  operation (envelope, z-normalization) is a reshape to ``(..., d, n)``
  plus the univariate code.
* **d = 1 is a no-op.**  Flattening a ``(..., n, 1)`` array is exactly
  ``squeeze(-1)``: bytes identical to the univariate layout.

The helpers work on numpy arrays and torch tensors alike (both expose
``swapaxes`` / ``reshape``).
"""

from __future__ import annotations

import numpy as np


def num_channels(x) -> int:
    """Channel count of an API-facing array: ``(..., n, d) -> d``;
    1-D/2-D (univariate) arrays are d = 1."""
    x = np.asarray(x) if not hasattr(x, "ndim") else x
    return int(x.shape[-1]) if x.ndim >= 3 else 1


def flatten_channels(x):
    """``(..., n, d)`` channel-minor -> ``(..., d*n)`` channel-major flat.
    ``(..., n, 1)`` flattens to the byte-identical univariate row."""
    if x.ndim < 2:
        raise ValueError(f"flatten_channels expects (..., n, d), got {tuple(x.shape)}")
    n, d = x.shape[-2], x.shape[-1]
    return x.swapaxes(-1, -2).reshape(tuple(x.shape[:-2]) + (d * n,))


def _segment_length(total: int, d: int) -> int:
    if d < 1 or total % d:
        raise ValueError(f"flat length {total} is not a multiple of d={d} channels")
    return total // d


def unflatten_channels(x, d: int):
    """Inverse of :func:`flatten_channels`: ``(..., d*n) -> (..., n, d)``."""
    d = int(d)
    n = _segment_length(x.shape[-1], d)
    return x.reshape(tuple(x.shape[:-1]) + (d, n)).swapaxes(-1, -2)


def channel_segments(x, d: int):
    """View a flattened ``(..., d*n)`` array as ``(..., d, n)``: the
    per-channel segment axis the envelope and z-norm helpers reduce over."""
    d = int(d)
    n = _segment_length(x.shape[-1], d)
    return x.reshape(tuple(x.shape[:-1]) + (d, n))
