"""LB_Improved pass 2: the K3 CUDA kernel's wrappers and plain version.

The kernel (``csrc/lb_improved.cu``) replaces the TPU kernels
``repro/kernels/lb_improved/kernel.py::lb_improved_pass2_qbatch_pallas``
and, as its Q = 1 case, ``lb_improved_pass2_pallas``.  Its input is a
stack of projection rows H (P, n) with one query row per H row: either
the dense (Q, B) stack or an explicit (P,) query index, so one entry
serves the dense stage and the compacted per-pair stage.  The envelope
of H is padded inside the kernel; no padded copy of H is made.  The
kernel runs one warp per H row; where a warp's buffers overflow a
block's shared memory (long rows) it keeps them in a workspace that the
launch allocates (``cuda_lib.workspace``), so every length runs.

The full bound is lb1 + lb2 (the max of the two at p = inf), where the
reference op adds them even at p = inf with lb1 = inf from its LB_Keogh
kernel; here both passes use the max form at p = inf.

Multivariate rows (``d > 1``, channel-major flattened (d*n,) with
per-segment envelopes) follow the reference op's folding: each channel
segment of H becomes a row of its own against the matching segment of
its query, so pass 2's envelope stays inside its segment, and the
per-channel terms are summed (maxed at p = inf) outside the launch.  The
regrouping is indexing, not a copy: the (Q, B, d*n) stack is read as
(Q*B*d, n) rows, each with its folded query row ``q*d + ch`` passed to
the kernel's per-row query index.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import lb as lb_mod
from repro_torch.core.envelope import envelope_batch
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import (
    check_cuda_tensor,
    count_launch,
    kernel_dtype,
    p_code,
)
from repro_torch.kernels.lb_keogh.ops import (
    lb_keogh_qbatch_op,
    lb_keogh_stream_plain,
    lb_keogh_stream_qbatch_op,
)


def lb_improved_pass2_plain(h, qs, w: int, p=1, qidx=None):
    """Plain PyTorch version: h (Q, B, n) dense or (P, n) with qidx (P,)
    -> lb2 (Q, B) or (P,)."""
    w = int(min(w, h.shape[-1] - 1))
    hu, hl = envelope_batch(h, w)
    q = qs[:, None, :] if qidx is None else qs[qidx]
    return lb_mod.lb_keogh_powered(q, hu, hl, p)


def lb_improved_pass2_launch(h, qs, w: int, p=1, qidx=None):
    """Launch K3 on CUDA tensors; shapes follow lb_improved_pass2_plain."""
    dev, dt = h.device, h.dtype
    n = h.shape[-1]
    w = int(min(w, n - 1))
    check_cuda_tensor("h", h, dev, dt)
    check_cuda_tensor("qs", qs, dev, dt, (qs.shape[0], n))
    if qidx is None:
        nq, b = h.shape[0], h.shape[1]
        if nq != qs.shape[0]:
            raise ValueError(f"h has {nq} query rows, qs has {qs.shape[0]}")
        rows, lead, bstride = nq * b, (nq, b), b
    else:
        rows, lead, bstride = h.shape[0], (h.shape[0],), 1
        check_cuda_tensor("qidx", qidx, dev, torch.int64, (rows,))
    lb2 = torch.empty(lead, dtype=dt, device=dev)
    ws = cuda_lib.workspace("lb_improved_pass2", dev, kernel_dtype(h), rows, n, w)
    code = cuda_lib.library().repro_lb_improved_pass2(
        kernel_dtype(h), p_code(p), h.data_ptr(), qs.data_ptr(),
        cuda_lib.ptr(qidx), rows, bstride, n, w, lb2.data_ptr(), cuda_lib.ptr(ws),
        cuda_lib.stream_of(dev),
    )
    cuda_lib.check("lb_improved_pass2", code)
    if rows:
        count_launch(lb_improved_pass2_launch)
    return lb2


lb_improved_pass2_launch.launches = 0


def _dispatch(h, qs, w, p, qidx):
    if h.device.type == "cpu":
        return lb_improved_pass2_plain(h, qs, w, p, qidx)
    if h.device.type != "cuda":
        raise ValueError(f"lb_improved runs on cuda or cpu, got {h.device}")
    return lb_improved_pass2_launch(h, qs, w, p, qidx)


@functools.lru_cache(maxsize=64)
def _folded_qidx(nq: int, b: int, d: int, device: torch.device) -> torch.Tensor:
    """The folded query row of each (q, b, ch) row of a dense (Q, B, d*n)
    stack read as (Q*B*d, n): ``q*d + ch``."""
    r = torch.arange(nq * b * d, device=device)
    return (r // (b * d)) * d + r % d


def _sum_channels(lb2, p):
    """(..., d) per-channel pass-2 terms -> (...): their sum, the max at
    p = inf."""
    return lb2.amax(dim=-1) if p == math.inf else lb2.sum(dim=-1)


def _folded(h, qs, w, p, qidx, d):
    """Pass 2 of channel-major flattened rows, the channels folded into
    the rows of one launch (module docstring)."""
    total = h.shape[-1]
    if total % d:
        raise ValueError(f"row length {total} not a multiple of d={d}")
    n = total // d
    qs_ch = qs.reshape(qs.shape[0] * d, n)
    lead = h.shape[:-1]
    rows = h.reshape(-1, n)
    if qidx is None:
        nq, b = lead
        if nq != qs.shape[0]:
            raise ValueError(f"h has {nq} query rows, qs has {qs.shape[0]}")
        qi = _folded_qidx(nq, b, d, h.device)
    else:
        qi = (qidx[:, None] * d + torch.arange(d, device=qidx.device)).reshape(-1)
    return _sum_channels(_dispatch(rows, qs_ch, w, p, qi).reshape(*lead, d), p)


def lb_improved_pass2_qbatch_op(h, qs, w: int, p=1, d: int = 1):
    """Second term of Corollary 4 for projections h (Q, B, d*n) against
    queries (Q, d*n) -> (Q, B)."""
    if int(d) > 1:
        return _folded(h, qs, w, p, None, int(d))
    return _dispatch(h, qs, w, p, None)


def lb_improved_pass2_pairs_op(h, qs, qidx, w: int, p=1, d: int = 1):
    """Second term for projection rows h (P, d*n), row i against
    qs[qidx[i]] -> (P,)."""
    if int(d) > 1:
        return _folded(h, qs, w, p, qidx, int(d))
    return _dispatch(h, qs, w, p, qidx)


def lb_improved_pass2_op(h, q, w: int, p=1):
    """Second term for projections h (B, n) of one query q (n,) -> (B,)."""
    return lb_improved_pass2_qbatch_op(h[None], q[None, :], w, p)[0]


def combine_passes(lb1, lb2, p):
    return torch.maximum(lb1, lb2) if p == math.inf else lb1 + lb2


def lb_improved_qbatch_op(cands, qs, upper, lower, w: int, p=1, tile_b=None, d: int = 1):
    """Full powered LB_Improved, candidates (B, d*n) vs queries (Q, d*n)
    -> (Q, B): K2 emits the projection stack that K3 consumes (folded per
    channel at ``d > 1``)."""
    lb1, h = lb_keogh_qbatch_op(cands, upper, lower, p, tile_b)
    return combine_passes(lb1, lb_improved_pass2_qbatch_op(h, qs, w, p, d), p)


def lb_improved_op(cands, q, upper, lower, w: int, p=1):
    """Full powered LB_Improved for candidates (B, n) against one query."""
    return lb_improved_qbatch_op(
        cands, q[None, :], upper[None, :], lower[None, :], w, p
    )[0]


def lb_improved_stream_plain(segment, qs, upper, lower, n: int, w: int, hop: int = 1,
                             p=1):
    """Plain PyTorch version of the stream form: K7's then K3's plain
    versions -> (Q, B)."""
    lb1, h = lb_keogh_stream_plain(segment, upper, lower, n, hop, p)
    return combine_passes(lb1, lb_improved_pass2_plain(h, qs, w, p), p)


def lb_improved_stream_qbatch_op(segment, qs, upper, lower, n: int, w: int,
                                 hop: int = 1, p=1, tile_b=None):
    """Full powered LB_Improved for the hop-strided windows of a flat
    stream segment (L,) against a template batch (Q, n) -> (Q, B): K7
    reads the windows in place and emits their projections, K3 adds
    pass 2.  At p = inf the two passes join by max (the reference op adds
    them there, with an inf pass 1)."""
    lb1, h = lb_keogh_stream_qbatch_op(segment, upper, lower, n, hop, p, tile_b)
    return combine_passes(lb1, lb_improved_pass2_qbatch_op(h, qs, w, p), p)
