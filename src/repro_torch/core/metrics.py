"""Metric-property tooling for DTW — paper Sections 5-6 (port of
``repro.core.metrics``).

* ``triangle_ratio`` — C(x,y,z) = DTW(x,z) / (DTW(x,y) + DTW(y,z)); the
  paper histograms it over 100k random triples (values > 1 violate the
  triangle inequality).
* ``theorem1_bound`` — the tight weak triangle inequality constant
  min(2w+1, n)^(1/p) of Theorem 1.
* ``triangle_lower_bound`` — Theorem 1 rearranged into a lower bound on
  an unseen distance (the scalar form of ``index.triangle_lb``).
* ``violation_fraction`` — fraction of sampled triples violating the
  plain triangle inequality (paper: ~0% white noise / CBF, 15-20%
  random walk).

The distances are the plain PyTorch DPs of ``core.dtw``: the row DP at
finite p, the anti-diagonal DP at p = inf, as in the reference.  They run
on the inputs' device if they are tensors, else on ``device`` (default:
the GPU; ``RuntimeError`` when there is none).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.dtw import PNorm, dtw_banded, dtw_banded_diag
from repro_torch.kernels.common import resolve_device


def triangle_ratio(x, y, z, w: int, p: PNorm = 1, device=None) -> torch.Tensor:
    """C(x, y, z) from Section 6; series (n,) or row batches (P, n)."""
    dev = resolve_device(device, like=x)
    x, y, z = (torch.as_tensor(a, device=dev) for a in (x, y, z))
    fn = dtw_banded_diag if p == math.inf else dtw_banded
    dxz = fn(x, z, w, p)
    dxy = fn(x, y, w, p)
    dyz = fn(y, z, w, p)
    return dxz / (dxy + dyz + 1e-30)


def theorem1_bound(n: int, w: int, p: PNorm) -> float:
    """Constant c with DTW(x,y)+DTW(y,z) >= DTW(x,z)/c (Theorem 1)."""
    base = min(2 * int(w) + 1, int(n))
    if p == math.inf:
        return 1.0
    return float(base) ** (1.0 / float(p))


def triangle_lower_bound(d_xy_wide, d_yz, n: int, w: int, p: PNorm = 1,
                         device=None) -> torch.Tensor:
    """Per-pair lower bound on the unseen DTW^w(x, z) from Theorem 1:

        DTW^w(x, z) >= DTW^{2w}(x, y) / c - DTW^w(y, z)

    ``d_xy_wide`` at band min(2w, n-1), ``d_yz`` at band w (same-band
    substitution is unsound: banded DTW_inf violates the plain triangle
    inequality).  Rooted distances; broadcasts."""
    dev = resolve_device(device, like=d_xy_wide)
    d_xy_wide = torch.as_tensor(d_xy_wide, device=dev)
    c = torch.tensor(theorem1_bound(n, w, p), dtype=d_xy_wide.dtype, device=dev)
    lo = d_xy_wide / c - torch.as_tensor(d_yz, device=dev)
    return torch.clamp(lo, min=0.0)


def violation_fraction(series, rng, n_triples: int, w: int, p: PNorm = 1, device=None
                       ) -> tuple[float, torch.Tensor]:
    """Sample triples from ``series`` (B, n); return (violation frac, ratios)."""
    series = torch.as_tensor(series, device=resolve_device(device, like=series))
    b = series.shape[0]
    idx = torch.as_tensor(np.asarray(rng.integers(0, b, size=(n_triples, 3))),
                          device=series.device)
    ratios = triangle_ratio(series[idx[:, 0]], series[idx[:, 1]], series[idx[:, 2]], w, p)
    frac = float((ratios > 1.0 + 1e-6).to(torch.float32).mean())
    return frac, ratios
