from repro_torch.kernels.lb_fused.ops import (
    fused_smem_bytes,
    lb_fused_launch,
    lb_fused_plain,
    lb_fused_qbatch_op,
)
from repro_torch.kernels.lb_fused.ref import lb_fused_qbatch_ref

__all__ = [
    "fused_smem_bytes",
    "lb_fused_launch",
    "lb_fused_plain",
    "lb_fused_qbatch_op",
    "lb_fused_qbatch_ref",
]
