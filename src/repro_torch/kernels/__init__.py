"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Eight entries: ``envelope`` (K1), ``lb_keogh`` (K2, LB_Keogh + the
projection H) and its stream form ``lb_keogh_stream`` (K7),
``lb_improved_pass2`` (K3, pass 2 over H), ``lb_fused`` (K4, both passes
one warp per pair, pass 2 predicated on the bound), ``dtw`` (K5, the
banded DP with per-lane abandoning, also in a masked-dense form),
``lb_kim`` (K6; ``lb_kim_features`` counts the launches of its feature
phase alone, the query features of K4's kim entry) and ``block_merge`` (the host driver's top-k merge and
counters on the device, no TPU counterpart).  ``dtw_merge`` counts the
launches of K5's masked entry with the merge as its epilogue, the host
driver's loop's second launch per block; ``dtw_mv`` and ``dtw_merge_mv``
count those of K5's channel entry (multivariate rows, d > 1), and
``lb_keogh_stream_mv`` those of K7's (a d-channel stream segment).  Each package holds
``ops.py`` — the wrappers, the plain PyTorch version and the kernel's
launch function, which counts its launches — and, for a TPU kernel,
``ref.py``, the oracle.
A wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors.  ``tuning`` holds the schedule table the
wrappers resolve their launch shapes from.
"""

from repro_torch.kernels.block_merge.ops import block_merge_launch
from repro_torch.kernels.dtw.ops import (
    dtw_launch,
    dtw_merge_launch,
    dtw_merge_mv_launch,
    dtw_mv_launch,
)
from repro_torch.kernels.envelope.ops import envelope_launch
from repro_torch.kernels.lb_fused.ops import lb_fused_launch
from repro_torch.kernels.lb_improved.ops import lb_improved_pass2_launch
from repro_torch.kernels.lb_keogh.ops import (
    lb_keogh_launch,
    lb_keogh_stream_launch,
    lb_keogh_stream_mv_launch,
)
from repro_torch.kernels.lb_kim.ops import lb_kim_features_launch, lb_kim_launch

#: kernel name -> its launch function (which carries ``.launches``)
LAUNCHERS = {
    "envelope": envelope_launch,
    "lb_keogh": lb_keogh_launch,
    "lb_improved_pass2": lb_improved_pass2_launch,
    "dtw": dtw_launch,
    "lb_fused": lb_fused_launch,
    "lb_kim": lb_kim_launch,
    "lb_kim_features": lb_kim_features_launch,
    "lb_keogh_stream": lb_keogh_stream_launch,
    "block_merge": block_merge_launch,
    "dtw_merge": dtw_merge_launch,
    "dtw_mv": dtw_mv_launch,
    "dtw_merge_mv": dtw_merge_mv_launch,
    "lb_keogh_stream_mv": lb_keogh_stream_mv_launch,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
