from repro_torch.kernels.dtw.ops import (
    dtw_launch,
    dtw_masked_plain,
    dtw_masked_prepare,
    dtw_merge_launch,
    dtw_merge_plain,
    dtw_op,
    dtw_pairs_op,
    dtw_plain,
    dtw_qbatch_op,
    dtw_wavefront_plain,
)
from repro_torch.kernels.dtw.ref import dtw_early_ref, dtw_ref

__all__ = [
    "dtw_early_ref",
    "dtw_launch",
    "dtw_masked_plain",
    "dtw_masked_prepare",
    "dtw_merge_launch",
    "dtw_merge_plain",
    "dtw_op",
    "dtw_pairs_op",
    "dtw_plain",
    "dtw_qbatch_op",
    "dtw_ref",
    "dtw_wavefront_plain",
]
