"""Oracle of the envelope kernel (the core twin, held against numpy in tests)."""

from repro_torch.core.envelope import envelope_batch


def envelope_ref(xs, w: int):
    """(B, n) -> (U, L), each (B, n)."""
    return envelope_batch(xs, w)
