from repro_torch.kernels.lb_improved.ops import (
    combine_passes,
    lb_improved_op,
    lb_improved_pass2_launch,
    lb_improved_pass2_op,
    lb_improved_pass2_pairs_op,
    lb_improved_pass2_plain,
    lb_improved_pass2_qbatch_op,
    lb_improved_qbatch_op,
    lb_improved_stream_plain,
    lb_improved_stream_qbatch_op,
)
from repro_torch.kernels.lb_improved.ref import (
    lb_improved_qbatch_ref,
    lb_improved_ref,
    lb_improved_stream_qbatch_ref,
)

__all__ = [
    "combine_passes",
    "lb_improved_op",
    "lb_improved_pass2_launch",
    "lb_improved_pass2_op",
    "lb_improved_pass2_pairs_op",
    "lb_improved_pass2_plain",
    "lb_improved_pass2_qbatch_op",
    "lb_improved_qbatch_op",
    "lb_improved_qbatch_ref",
    "lb_improved_ref",
    "lb_improved_stream_plain",
    "lb_improved_stream_qbatch_op",
    "lb_improved_stream_qbatch_ref",
]
