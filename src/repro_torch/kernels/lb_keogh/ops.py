"""LB_Keogh + projection H: the K2 CUDA kernel and its stream entry K7,
their wrappers and plain versions.

The kernel (``csrc/lb_keogh.cu``) replaces the TPU kernels
``repro/kernels/lb_keogh/kernel.py::lb_keogh_qbatch_pallas`` and, as its
Q = 1 case, ``lb_keogh_pallas``.  It takes either the dense (Q, B) grid
of (query, candidate) pairs or explicit (qidx, cidx) pair lists.  Its
strided entry (K7) replaces ``lb_keogh_stream_qbatch_pallas``: the
candidates are the hop-strided windows of one flat stream segment, read
in place and never copied out.  Its channel entry (K7c) takes a
d-channel segment (d, L): window b's flat row is the d channel windows
at b * hop, channel-major, as the templates' (Q, d * n) rows are laid
out; its launches count as ``lb_keogh_stream_mv``.

At p = inf the reference kernel computes ``d ** p`` and returns inf; the
kernels and the plain versions here use the max form of
``repro.core.lb.lb_keogh_powered`` instead.

``tile_b`` is the kernels' warps (pairs) per block; ``None`` resolves it
from the active tune table (``kernels/tuning``).  It changes no output;
the launcher caps it at what the kernel's registers allow (float64
blocks of 32 warps cannot launch).
"""

from __future__ import annotations

import torch

from repro_torch.core import lb as lb_mod
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import (
    check_cuda_tensor,
    count_launch,
    kernel_dtype,
    p_code,
    warps_per_block,
)
from repro_torch.kernels.tuning.table import resolve_config


def _warps(tile_b, b: int, n: int) -> int:
    if tile_b is None:
        tile_b = resolve_config("lb_keogh", b=b, n=n, backend="cuda").tile_b
    return warps_per_block(tile_b)


def lb_keogh_plain(cands, upper, lower, p=1, qidx=None, cidx=None):
    """Plain PyTorch version: dense -> (lb (Q, B), H (Q, B, n)); with
    pair lists -> (lb (P,), H (P, n))."""
    if qidx is None:
        c, u, l = cands[None, :, :], upper[:, None, :], lower[:, None, :]
    else:
        c, u, l = cands[cidx], upper[qidx], lower[qidx]
    return lb_mod.lb_keogh_powered(c, u, l, p), lb_mod.project(c, u, l)


def lb_keogh_launch(cands, upper, lower, p=1, qidx=None, cidx=None, tile_b=None):
    """Launch K2 on CUDA tensors; the output shapes follow lb_keogh_plain."""
    dev, dt = cands.device, cands.dtype
    nc, n = cands.shape
    nq = upper.shape[0]
    check_cuda_tensor("cands", cands, dev, dt)
    check_cuda_tensor("upper", upper, dev, dt, (nq, n))
    check_cuda_tensor("lower", lower, dev, dt, (nq, n))
    if qidx is None:
        npairs, lead = nq * nc, (nq, nc)
    else:
        npairs, lead = qidx.shape[0], (qidx.shape[0],)
        check_cuda_tensor("qidx", qidx, dev, torch.int64, (npairs,))
        check_cuda_tensor("cidx", cidx, dev, torch.int64, (npairs,))
    warps = _warps(tile_b, nc, n)
    lb = torch.empty(lead, dtype=dt, device=dev)
    h = torch.empty(lead + (n,), dtype=dt, device=dev)
    code = cuda_lib.library().repro_lb_keogh(
        kernel_dtype(cands), p_code(p), cands.data_ptr(), upper.data_ptr(),
        lower.data_ptr(), cuda_lib.ptr(qidx), cuda_lib.ptr(cidx), npairs, nc,
        n, warps, lb.data_ptr(), h.data_ptr(), cuda_lib.stream_of(dev),
    )
    cuda_lib.check("lb_keogh", code)
    if npairs:
        count_launch(lb_keogh_launch)
    return lb, h


lb_keogh_launch.launches = 0


def _dispatch(cands, upper, lower, p, qidx, cidx, tile_b):
    if cands.device.type == "cpu":
        return lb_keogh_plain(cands, upper, lower, p, qidx, cidx)
    if cands.device.type != "cuda":
        raise ValueError(f"lb_keogh runs on cuda or cpu, got {cands.device}")
    return lb_keogh_launch(cands, upper, lower, p, qidx, cidx, tile_b)


def lb_keogh_qbatch_op(cands, upper, lower, p=1, tile_b=None):
    """Candidates (B, n) vs envelopes (Q, n) -> (lb (Q, B), H (Q, B, n))."""
    return _dispatch(cands, upper, lower, p, None, None, tile_b)


def lb_keogh_pairs_op(cands, upper, lower, qidx, cidx, p=1, tile_b=None):
    """Pairs (qidx[i], cidx[i]) -> (lb (P,), H (P, n)); the compacted form."""
    return _dispatch(cands, upper, lower, p, qidx, cidx, tile_b)


def lb_keogh_op(cands, upper, lower, p=1, tile_b=None):
    """One envelope (n,) against candidates (B, n) -> (lb (B,), H (B, n))."""
    lb, h = lb_keogh_qbatch_op(cands, upper[None, :], lower[None, :], p, tile_b)
    return lb[0], h[0]


# ------------------------------------------------------------- stream (K7)


def stream_windows(segment, n: int, hop: int = 1) -> int:
    """The number of hop-strided n-windows in a flat segment (L,)."""
    length = segment.shape[-1]
    if length < n:
        raise ValueError(f"segment of {length} samples holds no {n}-window")
    if hop < 1:
        raise ValueError(f"hop={hop} must be >= 1")
    return (length - n) // hop + 1


def stream_channels(segment, d: int):
    """A stream segment as its ``(d, L)`` channel rows: at d = 1 the L
    values of a flat segment as one row, at d > 1 a (d, L) segment."""
    d = int(d)
    if d < 1:
        raise ValueError(f"d must be >= 1 channels, got {d}")
    if d == 1:
        return segment.reshape(1, -1)
    if segment.dim() != 2 or segment.shape[0] != d:
        raise ValueError(
            f"a {d}-channel stream segment is (d, L) = ({d}, L), got "
            f"{tuple(segment.shape)}"
        )
    return segment


def stream_tile(segment, n: int, hop: int = 1, d: int = 1):
    """The (B, d * n) tile of a segment's hop-strided windows, each the d
    channel windows at one start, channel-major: what K7 reads in place."""
    seg = stream_channels(segment, d)
    nb = stream_windows(seg, n, hop)
    wins = seg.unfold(1, n, hop)  # (d, B, n)
    return wins.transpose(0, 1).reshape(nb, d * n)


def lb_keogh_stream_plain(segment, upper, lower, n: int, hop: int = 1, p=1, d: int = 1):
    """Plain PyTorch version of K7 (and K7c at ``d > 1``): the windows
    gathered into their (B, d * n) tile, then the dense plain version ->
    (lb (Q, B), H (Q, B, d * n))."""
    return lb_keogh_plain(stream_tile(segment, n, hop, d), upper, lower, p)


def lb_keogh_stream_launch(segment, upper, lower, n: int, hop: int = 1, p=1,
                           tile_b=None, d: int = 1):
    """Launch K7 on CUDA tensors; shapes follow lb_keogh_stream_plain.
    ``d > 1`` launches the channel entry K7c on a (d, L) segment (counted
    as ``lb_keogh_stream_mv_launch``)."""
    seg = stream_channels(segment, d)
    dev, dt = seg.device, seg.dtype
    nb = stream_windows(seg, n, hop)
    nq, flat = upper.shape[0], d * n
    check_cuda_tensor("segment", seg, dev, dt)
    check_cuda_tensor("upper", upper, dev, dt, (nq, flat))
    check_cuda_tensor("lower", lower, dev, dt, (nq, flat))
    warps = _warps(tile_b, nb, flat)
    lb = torch.empty((nq, nb), dtype=dt, device=dev)
    h = torch.empty((nq, nb, flat), dtype=dt, device=dev)
    lib = cuda_lib.library()
    if d == 1:
        code = lib.repro_lb_keogh_stream(
            kernel_dtype(seg), p_code(p), seg.data_ptr(), upper.data_ptr(),
            lower.data_ptr(), nq, nb, hop, n, warps, lb.data_ptr(), h.data_ptr(),
            cuda_lib.stream_of(dev),
        )
    else:
        code = lib.repro_lb_keogh_stream_mv(
            kernel_dtype(seg), p_code(p), seg.data_ptr(), seg.stride(0),
            upper.data_ptr(), lower.data_ptr(), nq, nb, hop, n, d, warps,
            lb.data_ptr(), h.data_ptr(), cuda_lib.stream_of(dev),
        )
    cuda_lib.check("lb_keogh_stream", code)
    if nq * nb:
        count_launch(lb_keogh_stream_launch if d == 1 else lb_keogh_stream_mv_launch)
    return lb, h


lb_keogh_stream_launch.launches = 0


def lb_keogh_stream_mv_launch(segment, upper, lower, n: int, hop: int = 1, p=1,
                              tile_b=None, d: int = 2):
    """K7's channel entry on CUDA tensors: ``lb_keogh_stream_launch`` at
    ``d > 1`` channels, which counts its launches here."""
    if d < 2:
        raise ValueError(f"the channel entry takes d > 1 channels, got d={d}")
    return lb_keogh_stream_launch(segment, upper, lower, n, hop, p, tile_b, d)


lb_keogh_stream_mv_launch.launches = 0


def lb_keogh_stream_qbatch_op(segment, upper, lower, n: int, hop: int = 1, p=1,
                              tile_b=None, d: int = 1):
    """Stream-packed LB_Keogh: the ``B = (L - n) // hop + 1`` hop-strided
    windows of a segment, flat (L,) or (d, L) at ``d > 1`` channels, vs
    envelopes (Q, d * n) -> (lb (Q, B), H (Q, B, d * n)), the windows read
    in place."""
    if segment.device.type == "cpu":
        return lb_keogh_stream_plain(segment, upper, lower, n, hop, p, d)
    if segment.device.type != "cuda":
        raise ValueError(f"lb_keogh_stream runs on cuda or cpu, got {segment.device}")
    return lb_keogh_stream_launch(segment, upper, lower, n, hop, p, tile_b, d)
