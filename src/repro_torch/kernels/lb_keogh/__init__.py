from repro_torch.kernels.lb_keogh.ops import (
    lb_keogh_launch,
    lb_keogh_op,
    lb_keogh_pairs_op,
    lb_keogh_plain,
    lb_keogh_qbatch_op,
    lb_keogh_stream_launch,
    lb_keogh_stream_mv_launch,
    lb_keogh_stream_plain,
    lb_keogh_stream_qbatch_op,
    stream_tile,
)
from repro_torch.kernels.lb_keogh.ref import (
    lb_keogh_qbatch_ref,
    lb_keogh_ref,
    lb_keogh_stream_qbatch_ref,
    materialize_windows,
)

__all__ = [
    "lb_keogh_launch",
    "lb_keogh_op",
    "lb_keogh_pairs_op",
    "lb_keogh_plain",
    "lb_keogh_qbatch_op",
    "lb_keogh_qbatch_ref",
    "lb_keogh_ref",
    "lb_keogh_stream_launch",
    "lb_keogh_stream_mv_launch",
    "lb_keogh_stream_plain",
    "lb_keogh_stream_qbatch_op",
    "lb_keogh_stream_qbatch_ref",
    "materialize_windows",
    "stream_tile",
]
