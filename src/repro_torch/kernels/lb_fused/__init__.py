from repro_torch.kernels.lb_fused.ops import (
    PAD_STAGE,
    fused_long,
    fused_smem_bytes,
    lb_fused_launch,
    lb_fused_plain,
    lb_fused_prepare,
    lb_fused_qbatch_op,
    lb_fused_stage_plain,
)
from repro_torch.kernels.lb_fused.ref import lb_fused_qbatch_ref

__all__ = [
    "PAD_STAGE",
    "fused_long",
    "fused_smem_bytes",
    "lb_fused_launch",
    "lb_fused_plain",
    "lb_fused_prepare",
    "lb_fused_qbatch_op",
    "lb_fused_qbatch_ref",
    "lb_fused_stage_plain",
]
