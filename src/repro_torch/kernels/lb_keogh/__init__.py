from repro_torch.kernels.lb_keogh.ops import (
    lb_keogh_launch,
    lb_keogh_op,
    lb_keogh_pairs_op,
    lb_keogh_plain,
    lb_keogh_qbatch_op,
)
from repro_torch.kernels.lb_keogh.ref import lb_keogh_qbatch_ref, lb_keogh_ref

__all__ = [
    "lb_keogh_launch",
    "lb_keogh_op",
    "lb_keogh_pairs_op",
    "lb_keogh_plain",
    "lb_keogh_qbatch_op",
    "lb_keogh_qbatch_ref",
    "lb_keogh_ref",
]
