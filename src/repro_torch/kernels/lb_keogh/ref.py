"""Oracles of the LB_Keogh kernel (the core twins)."""

from repro_torch.core.lb import (
    lb_keogh_powered_batch,
    lb_keogh_powered_qbatch,
    project,
)


def lb_keogh_ref(cands, upper, lower, p=1):
    lb = lb_keogh_powered_batch(cands, upper, lower, p)
    return lb, project(cands, upper[None, :], lower[None, :])


def lb_keogh_qbatch_ref(cands, upper, lower, p=1):
    """(B, n) candidates vs (Q, n) envelopes -> (lb (Q, B), H (Q, B, n))."""
    lb = lb_keogh_powered_qbatch(cands, upper, lower, p)
    h = project(cands[None, :, :], upper[:, None, :], lower[:, None, :])
    return lb, h
