"""Oracle of the fused LB kernel: the dense pass-1 and two-pass forms of
``repro_torch.core.lb``, with the per-lane predication applied after."""

import torch

from repro_torch.core import lb as lb_mod


def lb_fused_qbatch_ref(cands, qs, upper, lower, w: int, bounds, p=1):
    lb1 = lb_mod.lb_keogh_powered_qbatch(cands, upper, lower, p)
    lbi = lb_mod.lb_improved_powered_qbatch(cands, qs, upper, lower, w, p)
    return lb1, torch.where(lb1 < bounds.reshape(-1, 1), lbi, lb1)
