"""LB_Kim: the K6 CUDA kernel's wrapper and plain version.

The kernel (``csrc/lb_kim.cu``) replaces the TPU kernel
``repro/kernels/lb_kim/kernel.py::lb_kim_qbatch_pallas``: the powered
LB_Kim of every (query, candidate) pair from the first, last, max and min
features, for p in {1, 2, inf}, with an optional (Q, B) entry mask whose
dead lanes (falsy, or <= 0 for a float mask) give BIG.  The kernel's
result is bit-equal to the plain version's.

``tile_b`` is the kernel's warps (pairs) per block; ``None`` resolves it
from the active tune table.  A ragged B needs no padding: each warp masks
its own pair.
"""

from __future__ import annotations

import torch

from repro_torch.core import lb as lb_mod
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import (
    BIG,
    check_cuda_tensor,
    kernel_dtype,
    p_code,
    warps_per_block,
)
from repro_torch.kernels.tuning.table import resolve_config


def _live(mask):
    return mask if mask.dtype == torch.bool else mask > 0


def lb_kim_plain(cands, qs, mask=None, p=1):
    """Plain PyTorch version: cands (B, n), qs (Q, n) -> (Q, B)."""
    lb = lb_mod.lb_kim_powered_qbatch(cands, qs, p)
    if mask is None:
        return lb
    return torch.where(_live(mask), lb, torch.full((), BIG, dtype=lb.dtype, device=lb.device))


def lb_kim_launch(cands, qs, mask=None, p=1, tile_b=None):
    """Launch K6 on CUDA tensors; shapes follow lb_kim_plain."""
    dev, dt = cands.device, cands.dtype
    nb, n = cands.shape
    nq = qs.shape[0]
    check_cuda_tensor("cands", cands, dev, dt)
    check_cuda_tensor("qs", qs, dev, dt, (nq, n))
    live = None
    if mask is not None:
        if tuple(mask.shape) != (nq, nb):
            raise ValueError(f"mask has shape {tuple(mask.shape)}, expected {(nq, nb)}")
        live = _live(mask).contiguous()
        check_cuda_tensor("mask", live, dev, torch.bool, (nq, nb))
    if tile_b is None:
        tile_b = resolve_config("lb_kim", b=nb, n=n, backend="cuda").tile_b
    warps = warps_per_block(tile_b)
    lb = torch.empty((nq, nb), dtype=dt, device=dev)
    code = cuda_lib.library().repro_lb_kim(
        kernel_dtype(cands), p_code(p), cands.data_ptr(), qs.data_ptr(),
        cuda_lib.ptr(live), nq, nb, n, warps, lb.data_ptr(), cuda_lib.stream_of(dev),
    )
    cuda_lib.check("lb_kim", code)
    if nq * nb:
        lb_kim_launch.launches += 1
    return lb


lb_kim_launch.launches = 0


def lb_kim_qbatch_op(cands, qs, mask=None, p=1, tile_b=None):
    """Query-major powered LB_Kim: candidates (B, n) vs queries (Q, n)
    -> (Q, B), BIG on lanes the entry mask (Q, B) marks dead."""
    if cands.device.type == "cpu":
        return lb_kim_plain(cands, qs, mask, p)
    if cands.device.type != "cuda":
        raise ValueError(f"lb_kim runs on cuda or cpu, got {cands.device}")
    return lb_kim_launch(cands, qs, mask, p, tile_b)
