"""Banded Dynamic Time Warping (DTW_p), plain PyTorch.

Port of ``repro.core.dtw``.  Banded values are stored in band
coordinates: for row i, band index k in [0, 2w] is column j = i + k - w.

* ``dtw_banded``       — row DP; the within-row (min,+) recurrence is
  solved in closed form with one ``cumsum`` + one ``cummin`` per row
  (finite p).
* ``dtw_banded_diag``  — anti-diagonal wavefront; every p, p = inf too.
* ``dtw_banded_early`` — the row DP with a per-lane powered abandon
  bound: a lane stops once its band minimum reaches the bound and then
  returns that minimum (>= bound); a lane that finishes is exact.
* ``dtw_reference``    — the O(n^2) float64 numpy oracle.

The torch functions take 1-D series or row batches ``(P, n)`` that
broadcast pairwise; the batch is the vmap of the JAX version written out.
The CUDA DP kernel (``kernels/dtw``) walks the anti-diagonals like
``dtw_banded_diag`` and returns its bits on every lane that finishes.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

BIG: float = 1.0e30

PNorm = Union[int, float]


def elem_cost(diff: torch.Tensor, p: PNorm) -> torch.Tensor:
    """|diff|^p for finite p, |diff| for p = inf (combined with max later)."""
    if p == math.inf or p == 1:
        return diff.abs()
    if p == 2:
        return diff * diff
    return diff.abs() ** p


def finish_cost(acc, p: PNorm):
    """Map the accumulated powered cost back to the l_p distance."""
    if p == math.inf or p == 1:
        return acc
    if p == 2:
        return acc.sqrt() if isinstance(acc, torch.Tensor) else np.sqrt(acc)
    return acc ** (1.0 / p)


def _pairs(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Broadcast two series or row batches to (P, n) each."""
    single = x.ndim == 1 and y.ndim == 1
    if x.shape[-1] != y.shape[-1]:
        raise ValueError(
            f"paper's DTW bounds assume equal lengths, got {x.shape[-1]} "
            f"!= {y.shape[-1]}"
        )
    x2 = x.reshape(-1, x.shape[-1])
    y2 = y.reshape(-1, y.shape[-1])
    x2, y2 = torch.broadcast_tensors(x2, y2)
    return x2, y2, single


def _band_index(i: int, n: int, w: int, device):
    """Columns and validity of band row ``i``: cell k is column i + k - w."""
    cols = i + torch.arange(2 * w + 1, device=device) - w
    valid = (cols >= 0) & (cols < n)
    return cols.clamp(0, n - 1), valid


def _row_step(prev, cost_row, valid_row):
    """One DP row from the previous one (the closed-form (min,+) scan)."""
    big = torch.full_like(prev[:, :1], BIG)
    up = torch.cat([prev[:, 1:], big], dim=1)
    b = torch.minimum(up, prev)
    cost_sum = torch.where(valid_row, cost_row, torch.zeros_like(cost_row))
    s = torch.cumsum(cost_sum, dim=1)
    t = torch.where(valid_row, b + cost_sum - s, torch.full_like(s, BIG))
    row = torch.clamp(s + torch.cummin(t, dim=1).values, max=BIG)
    return torch.where(valid_row, row, torch.full_like(row, BIG))


def _dtw_rows_early(x, y, w: int, bound, p: PNorm):
    """Row DP over (P, n) pairs with per-lane powered bounds (P,): the
    batched ``dtw_banded_early``.  Every row runs for every lane, but a
    lane's state freezes at the row where ``min(prev) >= bound`` first
    holds, exactly where the reference's while loop stops."""
    npair, n = x.shape
    width = 2 * w + 1
    prev = torch.full((npair, width), BIG, dtype=x.dtype, device=x.device)
    prev[:, w] = 0.0
    active = torch.ones(npair, dtype=torch.bool, device=x.device)
    done = torch.zeros(npair, dtype=torch.int64, device=x.device)
    for i in range(n):
        active = active & (prev.min(dim=1).values < bound)
        cols, valid = _band_index(i, n, w, x.device)
        cost = elem_cost(x[:, i : i + 1] - y[:, cols], p)
        row = _row_step(prev, cost, valid[None, :])
        prev = torch.where(active[:, None], row, prev)
        done = done + active.to(torch.int64)
    return torch.where(done == n, prev[:, w], prev.min(dim=1).values)


def dtw_banded(x, y, w: int, p: PNorm = 1, powered: bool = False):
    """DTW_p(x, y) with Sakoe-Chiba band half-width ``w`` (finite p)."""
    if p == math.inf:
        raise ValueError("use dtw_banded_diag for p = inf")
    x2, y2, single = _pairs(x, y)
    w = int(min(w, x2.shape[1] - 1))
    bound = torch.full((x2.shape[0],), BIG, dtype=x2.dtype, device=x2.device)
    out = _dtw_rows_early(x2, y2, w, bound, p)
    out = out if powered else finish_cost(out, p)
    return out[0] if single else out


def dtw_banded_early(x, y, w: int, bound, p: PNorm = 1):
    """Early-abandoning banded DTW: the powered DTW, or a value >= bound
    once every band cell of a row has reached ``bound``."""
    if p == math.inf:
        raise ValueError("early abandon implemented for finite p")
    x2, y2, single = _pairs(x, y)
    w = int(min(w, x2.shape[1] - 1))
    bound = torch.as_tensor(bound, dtype=x2.dtype, device=x2.device)
    bound = bound.reshape(-1).expand(x2.shape[0])
    out = _dtw_rows_early(x2, y2, w, bound, p)
    return out[0] if single else out


def dtw_banded_diag(x, y, w: int, p: PNorm = 1, powered: bool = False):
    """DTW_p via the anti-diagonal wavefront; supports every p including
    inf.  Slot e of a diagonal holds the cell with i - j = e - w."""
    x2, y2, single = _pairs(x, y)
    npair, n = x2.shape
    w = int(min(w, n - 1))
    width = 2 * w + 1
    dev = x2.device
    slots = torch.arange(width, device=dev)
    big_col = torch.full((npair, 1), BIG, dtype=x2.dtype, device=dev)
    dm1 = torch.full((npair, width), BIG, dtype=x2.dtype, device=dev)
    dm2 = dm1.clone()
    for d in range(2 * n - 1):
        i2 = d + (slots - w)
        i = torch.div(i2, 2, rounding_mode="floor")
        j = d - i
        ok = (i2 % 2 == 0) & (i >= 0) & (i < n) & (j >= 0) & (j < n)
        c = elem_cost(x2[:, i.clamp(0, n - 1)] - y2[:, j.clamp(0, n - 1)], p)
        up = torch.cat([big_col, dm1[:, :-1]], dim=1)
        left = torch.cat([dm1[:, 1:], big_col], dim=1)
        best = torch.minimum(torch.minimum(up, left), dm2)
        if d == 0:
            best[:, w] = 0.0  # origin: cell (0, 0) has no predecessor
        if p == math.inf:
            val = torch.maximum(c, best)
        else:
            val = c + best.clamp(max=BIG)
        val = torch.where(ok, val.clamp(max=BIG), torch.full_like(val, BIG))
        dm1, dm2 = val, dm1
    out = dm1[:, w]
    out = out if powered else finish_cost(out, p)
    return out[0] if single else out


def dtw_batch(query, candidates, w: int, p: PNorm = 1, powered: bool = False):
    """One query (n,) against candidates (B, n) -> (B,)."""
    fn = dtw_banded if p != math.inf else dtw_banded_diag
    return fn(query[None, :], candidates, w, p, powered)


def dtw_qbatch(queries, candidates, w: int, p: PNorm = 1, powered: bool = False):
    """Queries (Q, n) x candidates (B, n) -> (Q, B)."""
    nq, b = queries.shape[0], candidates.shape[0]
    fn = dtw_banded if p != math.inf else dtw_banded_diag
    qrows = queries[:, None, :].expand(nq, b, queries.shape[1])
    crows = candidates[None, :, :].expand(nq, b, candidates.shape[1])
    out = fn(qrows.reshape(nq * b, -1), crows.reshape(nq * b, -1), w, p, powered)
    return out.reshape(nq, b)


def dtw_reference(x, y, w: int, p: PNorm = 1) -> float:
    """O(n^2) numpy oracle.  Matches the paper's recursive definition
    exactly, including the w >= n unconstrained case."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, m = len(x), len(y)
    w_eff = max(int(w), abs(n - m))
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        lo = max(1, i - w_eff)
        hi = min(m, i + w_eff)
        for j in range(lo, hi + 1):
            d = abs(x[i - 1] - y[j - 1])
            c = d if p in (1, np.inf) else d**p
            best = min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
            D[i, j] = max(c, best) if p == np.inf else c + best
    q = D[n, m]
    if p in (1, np.inf):
        return float(q)
    return float(q ** (1.0 / p))
