"""Per-channel warping envelopes on channel-major flattened rows (port of
``repro.mv.envelope``).

The only operation the flattened layout cannot run verbatim is envelope
construction: a window crossing a channel-segment boundary would mix
samples of different channels.  So the mv envelope is the envelope
kernel (K1, ``kernels/envelope/ops.py::envelope_op``) over the
``(B*d, n)`` segment view, every channel segment one batch row, reshaped
back.  The elementwise bounds downstream run on the flattened rows
unchanged.  d = 1 calls ``envelope_op`` directly, the univariate program.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.envelope.ops import envelope_op


def envelope_batch_mv(xs: torch.Tensor, w: int, d: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, d*n) flattened rows -> per-channel (U, L), each (B, d*n); ``w``
    is clamped per channel, to n - 1."""
    return envelope_op(xs, w, d)


def envelope_mv(x: torch.Tensor, w: int, d: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Single flattened row (d*n,) -> per-channel (U, L), each (d*n,)."""
    u, lo = envelope_batch_mv(x[None, :], w, d)
    return u[0], lo[0]
