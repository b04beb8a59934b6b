"""The lower-bound family, plain PyTorch (port of ``repro.core.lb``).

The query ``q`` has a precomputed envelope (U, L); each candidate ``c``
is checked against it:

  H(c, q)            : projection of c onto the envelope of q   (Eq. 1)
  LB_Keogh_p(c, q)   = || c - H(c, q) ||_p                      (Cor. 3)
  LB_Improved_p(c,q)^p = LB_Keogh_p(c,q)^p
                        + LB_Keogh_p(q, H(c,q))^p               (Cor. 4)

plus LB_Kim (first/last/extremum, envelope-free) and LB_Webb (two-sided,
with the query's envelopes-of-envelopes correction); see the reference
module's docstring for the soundness arguments.  Values are *powered*
(sum |.|^p, no root; the plain max for p = inf) and broadcast over
leading dims.  These are the twins the CUDA kernels are held against.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.dtw import PNorm, elem_cost, finish_cost
from repro_torch.core.envelope import envelope, envelope_batch


def _reduce(d: torch.Tensor, p: PNorm) -> torch.Tensor:
    return d.amax(dim=-1) if p == math.inf else d.sum(dim=-1)


def _combine(pass1, pass2, p: PNorm):
    return torch.maximum(pass1, pass2) if p == math.inf else pass1 + pass2


def project(c, upper, lower):
    """H(c, q): clamp candidate into the envelope of the query (Eq. 1)."""
    return torch.minimum(torch.maximum(c, lower), upper)


def lb_keogh_powered(c, upper, lower, p: PNorm = 1):
    """sum_i |c_i - H(c,q)_i|^p (max for p=inf); broadcasts over leading dims."""
    over = torch.clamp(c - upper, min=0.0)
    under = torch.clamp(lower - c, min=0.0)
    return _reduce(elem_cost(over + under, p), p)


def lb_keogh(c, upper, lower, p: PNorm = 1):
    return finish_cost(lb_keogh_powered(c, upper, lower, p), p)


def lb_improved_powered(c, q, upper, lower, w: int, p: PNorm = 1):
    """Two-pass powered bound for a single candidate (1-D tensors)."""
    pass1 = lb_keogh_powered(c, upper, lower, p)
    hu, hl = envelope(project(c, upper, lower), w)
    return _combine(pass1, lb_keogh_powered(q, hu, hl, p), p)


def lb_improved(c, q, w: int, p: PNorm = 1):
    upper, lower = envelope(q, w)
    return finish_cost(lb_improved_powered(c, q, upper, lower, w, p), p)


# ---------------------------------------------------------------- batched


def lb_keogh_powered_batch(cs, upper, lower, p: PNorm = 1):
    """(B, n) candidates vs one envelope -> (B,) powered bounds."""
    return lb_keogh_powered(cs, upper[None, :], lower[None, :], p)


def lb_improved_powered_batch(cs, q, upper, lower, w: int, p: PNorm = 1):
    """(B, n) candidates -> (B,) powered two-pass bounds (both passes)."""
    pass1 = lb_keogh_powered_batch(cs, upper, lower, p)
    hu, hl = envelope_batch(project(cs, upper[None, :], lower[None, :]), w)
    return _combine(pass1, lb_keogh_powered(q[None, :], hu, hl, p), p)


# ------------------------------------------------------------ query-major


def lb_keogh_powered_qbatch(cs, upper, lower, p: PNorm = 1):
    """(B, n) candidates vs (Q, n) query envelopes -> (Q, B) powered bounds."""
    return lb_keogh_powered(cs[None, :, :], upper[:, None, :], lower[:, None, :], p)


def lb_improved_powered_qbatch(cs, qs, upper, lower, w: int, p: PNorm = 1):
    """(B, n) candidates vs (Q, n) queries -> (Q, B) powered two-pass bounds:
    pass 2 builds one envelope per (query, candidate) projection."""
    pass1 = lb_keogh_powered_qbatch(cs, upper, lower, p)
    h = project(cs[None, :, :], upper[:, None, :], lower[:, None, :])
    hu, hl = envelope_batch(h, w)
    return _combine(pass1, lb_keogh_powered(qs[:, None, :], hu, hl, p), p)


# ----------------------------------------------------------------- LB_Box


def lb_box_powered(cmin, cmax, upper, lower, p: PNorm = 1):
    """Powered LB_Keogh of a whole *box* of candidates against one query.

    ``[cmin, cmax]`` is an elementwise bounding box over a candidate set
    (a cluster of windows, ``repro_torch.anytime``); ``upper``/``lower``
    the query envelope at band w.  The per-sample interval distance
    ``g_i = max(0, lower_i - cmax_i, cmin_i - upper_i)`` is at most
    ``max(0, c_i - upper_i, lower_i - c_i)`` for every member ``c`` of the
    box, so the powered sum (max at p = inf) lower-bounds LB_Keogh(c, q),
    and hence DTW_p^w(q, c), for every member at once.  A box degenerated
    to one candidate (``cmin == cmax == c``) is LB_Keogh(c, q) exactly.
    Broadcasts over leading dims like ``lb_keogh_powered``."""
    under = torch.clamp(lower - cmax, min=0.0)
    over = torch.clamp(cmin - upper, min=0.0)
    return _reduce(elem_cost(under + over, p), p)


def lb_box(cmin, cmax, upper, lower, p: PNorm = 1):
    return finish_cost(lb_box_powered(cmin, cmax, upper, lower, p), p)


# ---------------------------------------------------------------- LB_Kim


def lb_kim_powered(c, q, p: PNorm = 1):
    """Powered LB_Kim: first + last powered costs add, extremum terms
    join by max (all four max-combined at p = inf)."""
    d_first = elem_cost((c[..., 0] - q[..., 0]).abs(), p)
    d_last = elem_cost((c[..., -1] - q[..., -1]).abs(), p)
    d_max = elem_cost((c.amax(dim=-1) - q.amax(dim=-1)).abs(), p)
    d_min = elem_cost((c.amin(dim=-1) - q.amin(dim=-1)).abs(), p)
    if p == math.inf:
        return torch.maximum(
            torch.maximum(d_first, d_last), torch.maximum(d_max, d_min)
        )
    return torch.maximum(d_first + d_last, torch.maximum(d_max, d_min))


def lb_kim(c, q, p: PNorm = 1):
    return finish_cost(lb_kim_powered(c, q, p), p)


def lb_kim_powered_batch(cs, q, p: PNorm = 1):
    """(B, n) candidates vs one query -> (B,) powered LB_Kim bounds."""
    return lb_kim_powered(cs, q[None, :], p)


def lb_kim_powered_qbatch(cs, qs, p: PNorm = 1):
    """(B, n) candidates vs (Q, n) queries -> (Q, B) powered LB_Kim bounds."""
    return lb_kim_powered(cs[None, :, :], qs[:, None, :], p)


# --------------------------------------------------------------- LB_Webb


def _webb_qside(q, cand_u, cand_l, q_ul, q_lu, p: PNorm):
    """Powered query-side Webb term: corrected per-sample distances of q
    to the candidate's envelope, summed (maxed for p = inf) over the last
    axis; ``q_ul``/``q_lu`` are ignored at p = inf."""
    if p == math.inf:
        d = torch.clamp(q - cand_u, min=0.0) + torch.clamp(cand_l - q, min=0.0)
        return elem_cost(d, p).amax(dim=-1)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    over = torch.where(
        q > cand_u, torch.clamp(q - torch.maximum(cand_u, q_ul), min=0.0), zero
    )
    under = torch.where(
        q < cand_l, torch.clamp(torch.minimum(cand_l, q_lu) - q, min=0.0), zero
    )
    return elem_cost(over + under, p).sum(dim=-1)


def envelope_of_envelopes(upper, lower, w: int):
    """(UL, LU) for LB_Webb's correction: the upper envelope of the lower
    envelope and the lower envelope of the upper envelope, band ``w``."""
    return envelope_batch(lower, w)[0], envelope_batch(upper, w)[1]


def lb_webb_powered(c, q, upper, lower, w: int, p: PNorm = 1):
    """Powered LB_Webb for a single (c, q) pair (1-D tensors)."""
    pass1 = lb_keogh_powered(c, upper, lower, p)
    cand_u, cand_l = envelope(c, w)
    q_ul, q_lu = envelope_of_envelopes(upper, lower, w)
    return _combine(pass1, _webb_qside(q, cand_u, cand_l, q_ul, q_lu, p), p)


def lb_webb(c, q, w: int, p: PNorm = 1):
    upper, lower = envelope(q, w)
    return finish_cost(lb_webb_powered(c, q, upper, lower, w, p), p)


def lb_webb_powered_qbatch(
    cs, qs, upper, lower, w: int, p: PNorm = 1,
    q_ul=None, q_lu=None, cand_u=None, cand_l=None,
):
    """(B, n) candidates vs (Q, n) queries -> (Q, B) powered LB_Webb.
    Precomputed ``q_ul``/``q_lu`` and ``cand_u``/``cand_l`` skip the
    envelope sweeps."""
    pass1 = lb_keogh_powered_qbatch(cs, upper, lower, p)
    if cand_u is None or cand_l is None:
        cand_u, cand_l = envelope_batch(cs, w)
    if p == math.inf:
        q_ul = q_lu = torch.zeros_like(qs)  # unused under max-combine
    elif q_ul is None or q_lu is None:
        q_ul, q_lu = envelope_of_envelopes(upper, lower, w)
    qside = _webb_qside(
        qs[:, None, :], cand_u[None, :, :], cand_l[None, :, :],
        q_ul[:, None, :], q_lu[:, None, :], p,
    )
    return _combine(pass1, qside, p)
