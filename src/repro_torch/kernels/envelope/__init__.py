from repro_torch.kernels.envelope.ops import envelope_launch, envelope_op, envelope_plain
from repro_torch.kernels.envelope.ref import envelope_ref

__all__ = ["envelope_launch", "envelope_op", "envelope_plain", "envelope_ref"]
