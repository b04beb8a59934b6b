"""Channel-summed LB_Kim / LB_Keogh / LB_Improved / LB_Webb, powered
(port of ``repro.mv.lb``).

For the dependent DTW of ``repro_torch.mv.dtw`` the warping path is
shared, so for each channel the scalar pair alignment is a valid
univariate banded path, every univariate bound holds per channel, and
the channel sum (max at p = inf) of the per-channel bounds lower-bounds
the dependent powered cost.  On the channel-major flattened layout that
channel sum is the ordinary last-axis reduction, so:

* **LB_Keogh** runs verbatim on flattened rows, given envelopes built per
  channel segment (``repro_torch.mv.envelope``);
* **LB_Kim** runs verbatim on flattened rows with no adjustment;
* **LB_Improved / LB_Webb** keep their distance arithmetic; only the
  envelope(-of-envelope) sweeps move to the per-segment form.

Every function is the univariate one at d = 1.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import lb as lb_mod
from repro_torch.core.dtw import PNorm, elem_cost
from repro_torch.mv.envelope import envelope_batch_mv


def lb_keogh_mv_powered(c, upper, lower, p: PNorm = 1):
    """Channel-summed powered LB_Keogh on flattened rows (the envelopes
    must be per segment)."""
    return lb_mod.lb_keogh_powered(c, upper, lower, p)


def lb_kim_mv_powered(c, q, p: PNorm = 1):
    """Powered LB_Kim on flattened rows: sound without an mv adjustment."""
    return lb_mod.lb_kim_powered(c, q, p)


def envelope_of_envelopes_mv(upper, lower, w: int, d: int = 1):
    """(UL, LU) for LB_Webb's correction, per channel segment; (d*n,) or
    batched (Q, d*n) envelopes."""
    if d == 1:
        return lb_mod.envelope_of_envelopes(upper, lower, w)
    return envelope_batch_mv(lower, w, d)[0], envelope_batch_mv(upper, w, d)[1]


def lb_improved_mv_powered_qbatch(cs, qs, upper, lower, w: int, p: PNorm = 1,
                                  d: int = 1):
    """(B, d*n) candidates vs (Q, d*n) queries -> (Q, B) powered two-pass
    bounds; the pass-2 envelope of the projection is per channel segment."""
    if d == 1:
        return lb_mod.lb_improved_powered_qbatch(cs, qs, upper, lower, w, p)
    nq, total = qs.shape
    b = cs.shape[0]
    pass1 = lb_mod.lb_keogh_powered_qbatch(cs, upper, lower, p)
    h = lb_mod.project(cs[None, :, :], upper[:, None, :], lower[:, None, :])
    hu, hl = envelope_batch_mv(h.reshape(nq * b, total), w, d)
    hu = hu.reshape(nq, b, total)
    hl = hl.reshape(nq, b, total)
    dd = elem_cost(
        torch.clamp(qs[:, None, :] - hu, min=0.0) + torch.clamp(hl - qs[:, None, :], min=0.0),
        p,
    )
    if p == math.inf:
        return torch.maximum(pass1, dd.amax(dim=-1))
    return pass1 + dd.sum(dim=-1)


def lb_webb_mv_powered_qbatch(cs, qs, upper, lower, w: int, p: PNorm = 1, d: int = 1,
                              q_ul=None, q_lu=None, cand_u=None, cand_l=None):
    """(B, d*n) candidates vs (Q, d*n) queries -> (Q, B) powered LB_Webb:
    the univariate query-side arithmetic on per-segment candidate
    envelopes and envelopes of envelopes."""
    if d == 1:
        return lb_mod.lb_webb_powered_qbatch(
            cs, qs, upper, lower, w, p, q_ul=q_ul, q_lu=q_lu, cand_u=cand_u, cand_l=cand_l,
        )
    if cand_u is None or cand_l is None:
        cand_u, cand_l = envelope_batch_mv(cs, w, d)
    if p != math.inf and (q_ul is None or q_lu is None):
        q_ul, q_lu = envelope_of_envelopes_mv(upper, lower, w, d)
    return lb_mod.lb_webb_powered_qbatch(
        cs, qs, upper, lower, w, p, q_ul=q_ul, q_lu=q_lu, cand_u=cand_u, cand_l=cand_l,
    )
