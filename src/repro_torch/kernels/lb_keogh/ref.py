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


def materialize_windows(segment, n: int, hop: int = 1):
    """(L,) flat segment -> (B, n) hop-strided window rows, copied (the
    materialization the stream kernel avoids)."""
    segment = segment.reshape(-1)
    return segment.unfold(0, n, hop).contiguous()


def lb_keogh_stream_qbatch_ref(segment, upper, lower, n: int, hop: int = 1, p=1):
    """Flat segment (L,) vs (Q, n) envelopes: materialize the window rows,
    then run the query-major oracle."""
    return lb_keogh_qbatch_ref(materialize_windows(segment, n, hop), upper, lower, p)
