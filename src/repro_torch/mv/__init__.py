"""Multivariate (d-channel) DTW tier: dependent DTW and channel-aware
bounds (port of ``repro.mv``).

One storage convention runs through it, the **channel-major flattened
layout**: a d-channel series of per-channel length n is stored as one
flat row of ``d * n`` values, the d contiguous length-n channel segments
``[ch0 | ch1 | ... | ch(d-1)]`` (``repro_torch.mv.layout``).  d = 1
flattened data is byte-identical to the univariate layout, and every
d = 1 path here is the univariate code.

* ``mv.envelope`` — per-segment envelopes (K1 over the segment view);
* ``mv.dtw`` — dependent DTW: one shared warping path, cell cost summed
  over the channels (max at p = inf); plain tensor code and the float64
  oracle (on the card the DP runs in K5's channel entry,
  ``kernels/dtw/ops.py``);
* ``mv.lb`` — the channel-summed LB_Kim, LB_Keogh, LB_Improved, LB_Webb;
* ``mv.tc`` — the TC-DTW stages ``tc_box`` and ``tc_tri``.
"""

from repro_torch.mv.dtw import (
    dtw_banded_diag_mv,
    dtw_banded_early_mv,
    dtw_banded_mv,
    dtw_batch_mv,
    dtw_qbatch_mv,
    dtw_reference_mv,
)
from repro_torch.mv.envelope import envelope_batch_mv, envelope_mv
from repro_torch.mv.layout import (
    channel_segments,
    flatten_channels,
    num_channels,
    unflatten_channels,
)
from repro_torch.mv.lb import (
    envelope_of_envelopes_mv,
    lb_improved_mv_powered_qbatch,
    lb_keogh_mv_powered,
    lb_kim_mv_powered,
    lb_webb_mv_powered_qbatch,
)
from repro_torch.mv.tc import (
    TC_BOX_SEGMENTS,
    box_segments,
    tc_box_powered_pair,
    tc_box_powered_qbatch,
    tc_tri_powered_pair,
    tc_tri_powered_qbatch,
)

__all__ = [
    "TC_BOX_SEGMENTS",
    "box_segments",
    "channel_segments",
    "dtw_banded_diag_mv",
    "dtw_banded_early_mv",
    "dtw_banded_mv",
    "dtw_batch_mv",
    "dtw_qbatch_mv",
    "dtw_reference_mv",
    "envelope_batch_mv",
    "envelope_mv",
    "envelope_of_envelopes_mv",
    "flatten_channels",
    "lb_improved_mv_powered_qbatch",
    "lb_keogh_mv_powered",
    "lb_kim_mv_powered",
    "lb_webb_mv_powered_qbatch",
    "num_channels",
    "tc_box_powered_pair",
    "tc_box_powered_qbatch",
    "tc_tri_powered_pair",
    "tc_tri_powered_qbatch",
    "unflatten_channels",
]
