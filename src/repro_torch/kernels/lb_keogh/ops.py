"""LB_Keogh + projection H: the K2 CUDA kernel's wrappers and plain version.

The kernel (``csrc/lb_keogh.cu``) replaces the TPU kernels
``repro/kernels/lb_keogh/kernel.py::lb_keogh_qbatch_pallas`` and, as its
Q = 1 case, ``lb_keogh_pallas``.  It takes either the dense (Q, B) grid
of (query, candidate) pairs or explicit (qidx, cidx) pair lists.

At p = inf the reference kernel computes ``d ** p`` and returns inf; the
kernel and the plain version here use the max form of
``repro.core.lb.lb_keogh_powered`` instead.
"""

from __future__ import annotations

import torch

from repro_torch.core import lb as lb_mod
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import check_cuda_tensor, kernel_dtype, p_code


def lb_keogh_plain(cands, upper, lower, p=1, qidx=None, cidx=None):
    """Plain PyTorch version: dense -> (lb (Q, B), H (Q, B, n)); with
    pair lists -> (lb (P,), H (P, n))."""
    if qidx is None:
        c, u, l = cands[None, :, :], upper[:, None, :], lower[:, None, :]
    else:
        c, u, l = cands[cidx], upper[qidx], lower[qidx]
    return lb_mod.lb_keogh_powered(c, u, l, p), lb_mod.project(c, u, l)


def lb_keogh_launch(cands, upper, lower, p=1, qidx=None, cidx=None):
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
    lb = torch.empty(lead, dtype=dt, device=dev)
    h = torch.empty(lead + (n,), dtype=dt, device=dev)
    code = cuda_lib.library().repro_lb_keogh(
        kernel_dtype(cands), p_code(p), cands.data_ptr(), upper.data_ptr(),
        lower.data_ptr(), cuda_lib.ptr(qidx), cuda_lib.ptr(cidx), npairs, nc,
        n, lb.data_ptr(), h.data_ptr(), cuda_lib.stream_of(dev),
    )
    cuda_lib.check("lb_keogh", code)
    if npairs:
        lb_keogh_launch.launches += 1
    return lb, h


lb_keogh_launch.launches = 0


def _dispatch(cands, upper, lower, p, qidx, cidx):
    if cands.device.type == "cpu":
        return lb_keogh_plain(cands, upper, lower, p, qidx, cidx)
    if cands.device.type != "cuda":
        raise ValueError(f"lb_keogh runs on cuda or cpu, got {cands.device}")
    return lb_keogh_launch(cands, upper, lower, p, qidx, cidx)


def lb_keogh_qbatch_op(cands, upper, lower, p=1):
    """Candidates (B, n) vs envelopes (Q, n) -> (lb (Q, B), H (Q, B, n))."""
    return _dispatch(cands, upper, lower, p, None, None)


def lb_keogh_pairs_op(cands, upper, lower, qidx, cidx, p=1):
    """Pairs (qidx[i], cidx[i]) -> (lb (P,), H (P, n)); the compacted form."""
    return _dispatch(cands, upper, lower, p, qidx, cidx)


def lb_keogh_op(cands, upper, lower, p=1):
    """One envelope (n,) against candidates (B, n) -> (lb (B,), H (B, n))."""
    lb, h = lb_keogh_qbatch_op(cands, upper[None, :], lower[None, :], p)
    return lb[0], h[0]
