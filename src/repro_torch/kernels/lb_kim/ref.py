"""Oracle of the LB_Kim kernel (the core twin, masked lanes BIG)."""

import torch

from repro_torch.core.lb import lb_kim_powered_qbatch
from repro_torch.kernels.common import BIG


def lb_kim_qbatch_ref(cands, qs, mask=None, p=1):
    """(B, n) candidates vs (Q, n) queries -> (Q, B); lanes where ``mask``
    (Q, B) is falsy give BIG."""
    lb = lb_kim_powered_qbatch(cands, qs, p)
    if mask is None:
        return lb
    return torch.where(mask > 0, lb, torch.full_like(lb, BIG))
