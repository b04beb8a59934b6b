"""Dependent multivariate banded DTW on channel-major flattened rows
(port of ``repro.mv.dtw``), plain PyTorch.

Dependent DTW: **one** warping path shared by all d channels, local cell
cost

    cost(i, j) = sum_ch |x_ch[i] - y_ch[j]|^p     (finite p)
               = max_ch |x_ch[i] - y_ch[j]|       (p = inf)

combined along the path by + (max at inf): the l_p norm over all aligned
(cell, channel) scalar pairs, which is univariate DTW_p at d = 1.  Every
function here dispatches to ``repro_torch.core.dtw`` at d = 1, so d = 1
values are the univariate ones.  The channel terms are combined in
channel order, one rounding each, as the DP kernel (K5's channel entry,
``csrc/dtw.cu``) combines them.

The torch functions take flattened rows ``(d*n,)`` or row batches
``(P, d*n)`` that broadcast pairwise, with the band half-width on the
per-channel time axis.  ``dtw_reference_mv`` is the O(n^2 d) float64
numpy oracle on channel-minor ``(n, d)`` series.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.dtw import (
    BIG,
    PNorm,
    _band_index,
    _pairs,
    _row_step,
    dtw_banded,
    dtw_banded_diag,
    dtw_banded_early,
    dtw_batch,
    dtw_qbatch,
    elem_cost,
    finish_cost,
)


def _channels(total: int, d: int) -> int:
    """Per-channel length n of a flattened row of ``total`` values."""
    if d < 1 or total % d:
        raise ValueError(f"flat length {total} not a multiple of d={d}")
    return total // d


def channel_cost(xv: torch.Tensor, yv: torch.Tensor, p: PNorm) -> torch.Tensor:
    """(..., d, k) aligned values of the two series -> (..., k) cell costs:
    the per-channel ``elem_cost`` summed (maxed at p = inf) in channel
    order."""
    c = elem_cost(xv[..., 0, :] - yv[..., 0, :], p)
    for ch in range(1, xv.shape[-2]):
        v = elem_cost(xv[..., ch, :] - yv[..., ch, :], p)
        c = torch.maximum(c, v) if p == math.inf else c + v
    return c


def _dtw_rows_early_mv(x, y, w: int, bound, p: PNorm, d: int):
    """Row DP over (P, d*n) pairs with per-lane powered bounds (P,), the
    batched ``dtw_banded_early_mv``: a lane's state freezes at the row
    where ``min(prev) >= bound`` first holds, and it then returns that
    minimum."""
    npair = x.shape[0]
    n = _channels(x.shape[1], d)
    x3 = x.reshape(npair, d, n)
    y3 = y.reshape(npair, d, n)
    width = 2 * w + 1
    prev = torch.full((npair, width), BIG, dtype=x.dtype, device=x.device)
    prev[:, w] = 0.0
    active = torch.ones(npair, dtype=torch.bool, device=x.device)
    done = torch.zeros(npair, dtype=torch.int64, device=x.device)
    for i in range(n):
        active = active & (prev.min(dim=1).values < bound)
        cols, valid = _band_index(i, n, w, x.device)
        cost = channel_cost(x3[:, :, i : i + 1], y3[:, :, cols], p)
        row = _row_step(prev, cost, valid[None, :])
        prev = torch.where(active[:, None], row, prev)
        done = done + active.to(torch.int64)
    return torch.where(done == n, prev[:, w], prev.min(dim=1).values)


def _diag_mv(x, y, w: int, p: PNorm, d: int):
    """Anti-diagonal wavefront over (P, d*n) pairs, every p; powered."""
    npair = x.shape[0]
    n = _channels(x.shape[1], d)
    x3 = x.reshape(npair, d, n)
    y3 = y.reshape(npair, d, n)
    width = 2 * w + 1
    dev = x.device
    slots = torch.arange(width, device=dev)
    big_col = torch.full((npair, 1), BIG, dtype=x.dtype, device=dev)
    dm1 = torch.full((npair, width), BIG, dtype=x.dtype, device=dev)
    dm2 = dm1.clone()
    for s in range(2 * n - 1):
        i2 = s + (slots - w)
        i = torch.div(i2, 2, rounding_mode="floor")
        j = s - i
        ok = (i2 % 2 == 0) & (i >= 0) & (i < n) & (j >= 0) & (j < n)
        c = channel_cost(x3[:, :, i.clamp(0, n - 1)], y3[:, :, j.clamp(0, n - 1)], p)
        up = torch.cat([big_col, dm1[:, :-1]], dim=1)
        left = torch.cat([dm1[:, 1:], big_col], dim=1)
        best = torch.minimum(torch.minimum(up, left), dm2)
        if s == 0:
            best[:, w] = 0.0  # origin: cell (0, 0) has no predecessor
        if p == math.inf:
            val = torch.maximum(c, best)
        else:
            val = c + best.clamp(max=BIG)
        val = torch.where(ok, val.clamp(max=BIG), torch.full_like(val, BIG))
        dm1, dm2 = val, dm1
    return dm1[:, w]


def _prepare(x, y, w: int, d: int):
    x2, y2, single = _pairs(x, y)
    n = _channels(x2.shape[1], d)
    return x2, y2, single, int(min(w, n - 1))


def dtw_banded_mv(x, y, w: int, p: PNorm = 1, powered: bool = False, d: int = 1):
    """Dependent DTW_p of flattened rows, row DP, finite p."""
    if p == math.inf:
        raise ValueError("use dtw_banded_diag_mv for p = inf")
    if d == 1:
        return dtw_banded(x, y, w, p, powered)
    x2, y2, single, w = _prepare(x, y, w, d)
    bound = torch.full((x2.shape[0],), BIG, dtype=x2.dtype, device=x2.device)
    out = _dtw_rows_early_mv(x2, y2, w, bound, p, d)
    out = out if powered else finish_cost(out, p)
    return out[0] if single else out


def dtw_banded_diag_mv(x, y, w: int, p: PNorm = 1, powered: bool = False, d: int = 1):
    """Dependent DTW_p via the anti-diagonal wavefront; every p, inf too."""
    if d == 1:
        return dtw_banded_diag(x, y, w, p, powered)
    x2, y2, single, w = _prepare(x, y, w, d)
    out = _diag_mv(x2, y2, w, p, d)
    out = out if powered else finish_cost(out, p)
    return out[0] if single else out


def dtw_banded_early_mv(x, y, w: int, bound, p: PNorm = 1, d: int = 1):
    """Early-abandoning dependent DP (finite p): the powered distance, or a
    value >= bound once every band cell of a row has reached ``bound``."""
    if p == math.inf:
        raise ValueError("early abandon implemented for finite p")
    if d == 1:
        return dtw_banded_early(x, y, w, bound, p)
    x2, y2, single, w = _prepare(x, y, w, d)
    bound = torch.as_tensor(bound, dtype=x2.dtype, device=x2.device)
    bound = bound.reshape(-1).expand(x2.shape[0])
    out = _dtw_rows_early_mv(x2, y2, w, bound, p, d)
    return out[0] if single else out


def dtw_batch_mv(query, candidates, w: int, p: PNorm = 1, powered: bool = False,
                 d: int = 1):
    """Dependent DTW of one query (d*n,) against candidates (B, d*n) -> (B,)."""
    if d == 1:
        return dtw_batch(query, candidates, w, p, powered)
    fn = dtw_banded_mv if p != math.inf else dtw_banded_diag_mv
    return fn(query[None, :], candidates, w, p, powered, d)


def dtw_qbatch_mv(queries, candidates, w: int, p: PNorm = 1, powered: bool = False,
                  d: int = 1):
    """Dependent DTW of queries (Q, d*n) x candidates (B, d*n) -> (Q, B)."""
    if d == 1:
        return dtw_qbatch(queries, candidates, w, p, powered)
    nq, b, total = queries.shape[0], candidates.shape[0], queries.shape[1]
    fn = dtw_banded_mv if p != math.inf else dtw_banded_diag_mv
    qrows = queries[:, None, :].expand(nq, b, total).reshape(nq * b, total)
    crows = candidates[None, :, :].expand(nq, b, total).reshape(nq * b, total)
    return fn(qrows, crows, w, p, powered, d).reshape(nq, b)


def dtw_reference_mv(x, y, w: int, p: PNorm = 1) -> float:
    """O(n^2 d) float64 numpy oracle for dependent multivariate DTW.

    ``x``/``y`` are channel-minor ``(n, d)`` (a 1-D array is d = 1), the
    API-facing layout, not flattened.  Matches ``dtw_reference`` at d = 1,
    including the w >= n unconstrained case."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"channel mismatch: {x.shape} vs {y.shape}")
    n, m = x.shape[0], y.shape[0]
    w_eff = max(int(w), abs(n - m))
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        lo = max(1, i - w_eff)
        hi = min(m, i + w_eff)
        for j in range(lo, hi + 1):
            diff = np.abs(x[i - 1] - y[j - 1])  # (d,)
            if p == np.inf:
                c = diff.max()
            elif p == 1:
                c = diff.sum()
            else:
                c = (diff**p).sum()
            best = min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
            D[i, j] = max(c, best) if p == np.inf else c + best
    q = D[n, m]
    if p in (1, np.inf):
        return float(q)
    return float(q ** (1.0 / p))
