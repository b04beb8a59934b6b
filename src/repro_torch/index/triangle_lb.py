"""LB_tri: the stage-0 lower bound from the tight weak triangle inequality
(port of ``repro.index.triangle_lb``).

Theorem 1's proof composes a w-banded warping path x<->y with a
w-banded path y<->z into a *2w*-banded alignment of (x, z) that reuses
every aligned pair at most min(2w+1, n) times:

    DTW_p^{2w}(x, z) <= c_w * (DTW_p^w(x, y) + DTW_p^w(y, z)),
    c_w = min(2w+1, n)^(1/p).

Rearranged around a reference r, two sound lower bounds on the unseen
DTW^w(q, c) follow, each mixing bands:

    DTW^w(q, c) >= DTW^{2w}(q, r) / c_w - DTW^w(r, c)        (side A)
    DTW^w(q, c) >= DTW^{2w}(r, c) / c_w - DTW^w(q, r)        (side B)

The band doubling matters: plain banded DTW_inf does not satisfy the
triangle inequality, so a bound built from same-band distances would
prune true neighbours.  ``LB_tri(q, c) = max_r max(A, B, 0)`` costs O(R)
arithmetic per candidate, because the reference matrices are built once.

Everything works on rooted distances; ``powered`` maps a rooted bound to
the cascade's powered threshold domain.  ``SLACK`` keeps float32
rounding from lifting a bound above the true distance on near ties.

The bounds are plain elementwise tensor code on their tensors' device,
as the reference computes them with jnp outside any kernel.  Each division
is a true IEEE division by the constant as a tensor of the operands'
dtype (a Python scalar divisor becomes a multiply by its reciprocal on
CUDA), so the CPU and the GPU give the same bits.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.dtw import PNorm

# multiplicative safety margin on the rooted bound (fp32 DTW noise)
SLACK: float = 1.0 - 1e-6


def wide_band(w: int, n: int) -> int:
    """The composed-path band: min(2w, n-1)."""
    return int(min(2 * int(w), int(n) - 1))


def powered(x, p: PNorm):
    """Inverse of ``finish_cost``: rooted l_p value -> powered value
    (tensors, numpy arrays or scalars)."""
    if p == math.inf or p == 1:
        return x
    if p == 2:
        return x * x
    return x ** p


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(c, dtype=like.dtype, device=like.device)


def _clamp_slack(lo: torch.Tensor) -> torch.Tensor:
    return torch.clamp(lo, min=0.0) * SLACK


def lb_triangle_pair(d_qr_wide: torch.Tensor, d_rc: torch.Tensor, c: float) -> torch.Tensor:
    """Side-A pair bound on DTW^w(q, c): DTW^{2w}(q, r)/c - DTW^w(r, c).

    ``d_qr_wide`` is the band-2w distance, ``d_rc`` the band-w one.
    Broadcasts; clamped at 0."""
    return _clamp_slack(d_qr_wide / _const(c, d_qr_wide) - d_rc)


def lb_triangle_batch(d_q_refs_w, d_q_refs_wide, d_ref_db_w, d_ref_db_wide,
                      c: float) -> torch.Tensor:
    """max over references of both pair-bound sides.

    d_q_refs_w / d_q_refs_wide: (..., R) rooted DTW(q, r) at band w / 2w,
    one query's (R,) or a batch's (Q, R).  d_ref_db_w / d_ref_db_wide:
    (R, N) rooted DTW(r, s) at band w / 2w.  Returns (..., N) rooted
    lower bounds on DTW^w(q, s), in the promoted dtype of the operands
    (a float64 query batch against the float32 index matrices computes in
    float64, as the reference does).  All four are tensors on one device."""
    side_a = d_q_refs_wide[..., :, None] / _const(c, d_q_refs_wide) - d_ref_db_w
    side_b = d_ref_db_wide / _const(c, d_ref_db_wide) - d_q_refs_w[..., :, None]
    return _clamp_slack(torch.maximum(side_a, side_b)).amax(dim=-2)


def lb_triangle_clusters(d_q_reps_w, d_q_reps_wide, radii_w, min_radii_wide,
                         c: float) -> torch.Tensor:
    """Cluster-granularity bound: it holds for every member of the cluster.

    For a member s of a cluster with representative m,
    DTW^w(m, s) <= radii_w and DTW^{2w}(m, s) >= min_radii_wide, so

        DTW^w(q, s) >= DTW^{2w}(q, m) / c - radii_w
        DTW^w(q, s) >= min_radii_wide / c - DTW^w(q, m)

    ``d_q_reps_*`` are (C,) for one query or (Q, C) for a batch; the (C,)
    radii broadcast.  If the bound already beats the running k-th best,
    the whole cluster dies in O(1).  All four are tensors on one device."""
    side_a = d_q_reps_wide / _const(c, d_q_reps_wide) - radii_w
    side_b = min_radii_wide / _const(c, min_radii_wide) - d_q_reps_w
    return _clamp_slack(torch.maximum(side_a, side_b))
