"""Oracles of the LB_Improved kernels (the core twins)."""

from repro_torch.core.lb import lb_improved_powered_batch, lb_improved_powered_qbatch


def lb_improved_ref(cands, q, upper, lower, w: int, p=1):
    return lb_improved_powered_batch(cands, q, upper, lower, w, p)


def lb_improved_qbatch_ref(cands, qs, upper, lower, w: int, p=1):
    """(B, n) candidates vs (Q, n) queries -> (Q, B) powered bounds."""
    return lb_improved_powered_qbatch(cands, qs, upper, lower, w, p)


def lb_improved_stream_qbatch_ref(segment, qs, upper, lower, n: int, w: int, hop: int = 1,
                                  p=1):
    """Flat segment (L,) vs (Q, n) templates: the materialized-window twin
    of the stream op."""
    from repro_torch.kernels.lb_keogh.ref import materialize_windows

    return lb_improved_powered_qbatch(
        materialize_windows(segment, n, hop), qs, upper, lower, w, p
    )
