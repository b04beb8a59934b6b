"""Oracles of the DTW kernel (the core twins, held against the O(n^2)
numpy DP ``dtw_reference`` in the tests)."""

from repro_torch.core.dtw import dtw_banded_early, dtw_batch, dtw_reference  # noqa: F401


def dtw_ref(q, cands, w: int, p=1, powered: bool = False):
    return dtw_batch(q, cands, w, p, powered)


def dtw_early_ref(q, cands, w: int, bounds, p=1):
    """Early-abandoning oracle (powered; abandoned lanes return >= bound)."""
    return dtw_banded_early(q[None, :], cands, w, bounds, p)
