"""LB_Kim: the K6 CUDA kernel's wrappers and plain versions.

The kernel (``csrc/lb_kim.cu``) replaces the TPU kernel
``repro/kernels/lb_kim/kernel.py::lb_kim_qbatch_pallas``: the powered
LB_Kim of every (query, candidate) pair from the first, last, max and min
features, for p in {1, 2, inf}, with an optional (Q, B) entry mask whose
dead lanes (falsy, or <= 0 for a float mask) give BIG.  The kernel's
result is bit-equal to the plain version's.

It runs in two phases in one launch: one warp per row reduces every
candidate and query row to its four features, once, into a workspace;
the last block to finish (a ticket, one zeroed counter per device and
stream that each launch leaves at 0) then writes the (Q, B) lanes.
``lb_kim_features_launch`` runs the first phase alone, rows (R, n) ->
(R, 4): the query features of K4's kim entry (``kernels/lb_fused``).

``tile_b`` is the kernel's warps (rows) per block; ``None`` resolves it
from the active tune table.  It changes no bit.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core import lb as lb_mod
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import (
    BIG,
    check_cuda_tensor,
    count_launch,
    kernel_dtype,
    p_code,
    warps_per_block,
)
from repro_torch.kernels.tuning.table import resolve_config

#: the ticket of each (device, stream): K6's last block finds itself by it
_TICKETS: dict = {}
_TICKETS_LOCK = threading.Lock()


def _live(mask):
    return mask if mask.dtype == torch.bool else mask > 0


def lb_kim_plain(cands, qs, mask=None, p=1):
    """Plain PyTorch version: cands (B, n), qs (Q, n) -> (Q, B)."""
    lb = lb_mod.lb_kim_powered_qbatch(cands, qs, p)
    if mask is None:
        return lb
    return torch.where(_live(mask), lb, torch.full((), BIG, dtype=lb.dtype, device=lb.device))


def lb_kim_features_plain(rows):
    """Plain version of the feature phase: rows (R, n) -> (R, 4), each
    row's first, last, max and min value."""
    return torch.stack([rows[:, 0], rows[:, -1], rows.amax(dim=1), rows.amin(dim=1)], dim=1)


def _warps(nb, n, tile_b):
    if tile_b is None:
        tile_b = resolve_config("lb_kim", b=nb, n=n, backend="cuda").tile_b
    return warps_per_block(tile_b)


def _ticket(dev):
    key = (dev, cuda_lib.stream_of(dev))
    with _TICKETS_LOCK:  # one ticket per stream, even when threads race
        if key not in _TICKETS:
            _TICKETS[key] = torch.zeros(1, dtype=torch.int64, device=dev)
        return _TICKETS[key]


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
    warps = _warps(nb, n, tile_b)
    lb = torch.empty((nq, nb), dtype=dt, device=dev)
    feats = torch.empty((nb + nq, 4), dtype=dt, device=dev)
    code = cuda_lib.library().repro_lb_kim(
        kernel_dtype(cands), p_code(p), cands.data_ptr(), qs.data_ptr(),
        cuda_lib.ptr(live), nq, nb, n, warps, feats.data_ptr(), _ticket(dev).data_ptr(),
        lb.data_ptr(), cuda_lib.stream_of(dev),
    )
    cuda_lib.check("lb_kim", code)
    if nq * nb:
        count_launch(lb_kim_launch)
    return lb


lb_kim_launch.launches = 0


def lb_kim_features_launch(rows, tile_b=None):
    """Launch K6's feature phase alone on a CUDA tensor (R, n) -> (R, 4)."""
    dev = rows.device
    nrows, n = rows.shape
    check_cuda_tensor("rows", rows, dev, rows.dtype)
    feats = torch.empty((nrows, 4), dtype=rows.dtype, device=dev)
    code = cuda_lib.library().repro_lb_kim_features(
        kernel_dtype(rows), rows.data_ptr(), nrows, n, _warps(nrows, n, tile_b),
        feats.data_ptr(), cuda_lib.stream_of(dev),
    )
    cuda_lib.check("lb_kim_features", code)
    if nrows:
        count_launch(lb_kim_features_launch)
    return feats


lb_kim_features_launch.launches = 0


def lb_kim_qbatch_op(cands, qs, mask=None, p=1, tile_b=None):
    """Query-major powered LB_Kim: candidates (B, n) vs queries (Q, n)
    -> (Q, B), BIG on lanes the entry mask (Q, B) marks dead."""
    if cands.device.type == "cpu":
        return lb_kim_plain(cands, qs, mask, p)
    if cands.device.type != "cuda":
        raise ValueError(f"lb_kim runs on cuda or cpu, got {cands.device}")
    return lb_kim_launch(cands, qs, mask, p, tile_b)
