"""Fused LB_Keogh -> LB_Improved: the K4 CUDA kernel's wrapper and plain
version.

The kernel (``csrc/lb_fused.cu``) replaces the TPU kernel
``repro/kernels/lb_fused/kernel.py::lb_fused_qbatch_pallas``.  For
candidates (B, n) against queries (Q, n) with their envelopes and a
powered pruning bound per query, it returns (lb1, lb) of shape (Q, B):
LB_Keogh for every lane, and the full LB_Improved where lb1 < bound
(lb == lb1 elsewhere).  The projections H stay in shared memory, and a
tile with no live lane skips pass 2.  lb1 is bit-equal to K2's LB_Keogh
and lb to K2's plus K3's pass 2, the two kernels the host driver would
otherwise launch (``csrc/lb_routines.cuh``).

The reference op serves p in {1, 2} only and raises otherwise; so does
this one.  A ragged B needs no padding: the kernel masks the last tile,
so no pad lane can keep pass 2 alive (the reason the reference pads with
``PAD_VALUE`` rather than zeros).

``tile_b`` (candidate rows per block), ``grid`` (``"qb"``: a block per
(query, tile); ``"bq"``: a block per tile, looping over the queries) and
``depth`` left ``None`` resolve from the active tune table; none changes
an output bit.  The kernel has no ``cp.async`` double buffering yet, so
``depth=2`` cannot launch.  A resolved tile too large for shared memory
at this length is halved until it fits; an explicit one raises
:class:`~repro_torch.kernels.common.NotRunnable`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import (
    SMEM_LIMIT_BYTES,
    NotRunnable,
    check_cuda_tensor,
    kernel_dtype,
    p_code,
)
from repro_torch.kernels.lb_improved.ops import combine_passes, lb_improved_pass2_plain
from repro_torch.kernels.lb_keogh.ops import lb_keogh_plain
from repro_torch.kernels.tuning.space import GRID_LAYOUTS
from repro_torch.kernels.tuning.table import resolve_config


def _check_p(p):
    if p not in (1, 2):
        raise ValueError("kernel fast path supports p in {1, 2}")


def lb_fused_plain(cands, qs, upper, lower, w: int, bounds, p=1):
    """Plain PyTorch version: K2's and K3's plain versions, pass 2 kept
    where lb1 < bound -> (lb1 (Q, B), lb (Q, B))."""
    _check_p(p)
    w = int(min(w, cands.shape[-1] - 1))
    lb1, h = lb_keogh_plain(cands, upper, lower, p)
    lb2 = lb_improved_pass2_plain(h, qs, w, p)
    alive = lb1 < bounds.reshape(-1, 1)
    return lb1, torch.where(alive, combine_passes(lb1, lb2, p), lb1)


def fused_smem_bytes(n: int, w: int, tile_b: int, grid: str, itemsize: int) -> int:
    """Shared memory of one K4 block: tile_b rows of H (and of the staged
    tile for ``"bq"``), the pass-2 envelope buffer, the tile's lb1 values
    and the 32-value reduction scratch."""
    rows = tile_b * n * (2 if grid == "bq" else 1)
    return itemsize * (rows + 4 * (n + 2 * w) + tile_b + 32)


def lb_fused_launch(cands, qs, upper, lower, w: int, bounds, p=1, tile_b=None,
                    depth=None, grid=None):
    """Launch K4 on CUDA tensors; shapes follow lb_fused_plain."""
    _check_p(p)
    dev, dt = cands.device, cands.dtype
    nb, n = cands.shape
    nq = qs.shape[0]
    w = int(min(w, n - 1))
    for name, t in (("cands", cands), ("qs", qs), ("upper", upper), ("lower", lower)):
        check_cuda_tensor(name, t, dev, dt, None if name == "cands" else (nq, n))
    bounds = bounds.reshape(-1)
    check_cuda_tensor("bounds", bounds, dev, dt, (nq,))
    shrink = tile_b is None
    if tile_b is None or depth is None or grid is None:
        cfg = resolve_config("lb_fused", b=nb, n=n, backend="cuda")
        tile_b = cfg.tile_b if tile_b is None else tile_b
        depth = cfg.depth if depth is None else depth
        grid = cfg.grid if grid is None else grid
    if grid not in GRID_LAYOUTS:
        raise ValueError(f"grid must be one of {GRID_LAYOUTS}, got {grid!r}")
    if depth != 1:
        raise NotRunnable(
            f"depth={depth}: the CUDA lb_fused kernel has no cp.async double "
            "buffering yet (ROADMAP.md queue 2)"
        )
    tile_b = int(tile_b)
    if tile_b < 1:
        raise NotRunnable(f"tile_b={tile_b} rows per block")
    while fused_smem_bytes(n, w, tile_b, grid, cands.element_size()) > SMEM_LIMIT_BYTES:
        if not shrink or tile_b == 1:
            raise NotRunnable(
                f"lb_fused tile_b={tile_b} grid={grid!r} needs "
                f"{fused_smem_bytes(n, w, tile_b, grid, cands.element_size())} bytes "
                f"of shared memory at n={n}, w={w}; the limit is {SMEM_LIMIT_BYTES}"
            )
        tile_b //= 2
    lb1 = torch.empty((nq, nb), dtype=dt, device=dev)
    lb = torch.empty((nq, nb), dtype=dt, device=dev)
    code = cuda_lib.library().repro_lb_fused(
        kernel_dtype(cands), p_code(p), cands.data_ptr(), qs.data_ptr(),
        upper.data_ptr(), lower.data_ptr(), bounds.data_ptr(), nq, nb, n, w,
        tile_b, int(grid == "bq"), lb1.data_ptr(), lb.data_ptr(),
        cuda_lib.stream_of(dev),
    )
    cuda_lib.check("lb_fused", code)
    if nq * nb:
        lb_fused_launch.launches += 1
    return lb1, lb


lb_fused_launch.launches = 0


def lb_fused_qbatch_op(cands, qs, upper, lower, w: int, bounds, p=1, tile_b=None,
                       depth=None, grid=None, d: int = 1):
    """Both passes of the two-pass bound in one launch: candidates (B, n)
    vs queries (Q, n) with envelopes (Q, n) and per-query powered
    ``bounds`` (Q,) -> (lb1 (Q, B), lb (Q, B)), lb == lb1 on lanes with
    lb1 >= bound."""
    _check_p(p)
    if int(d) != 1:
        from repro_torch.core.pipeline import require_univariate

        require_univariate(d)
    if cands.device.type == "cpu":
        return lb_fused_plain(cands, qs, upper, lower, w, bounds, p)
    if cands.device.type != "cuda":
        raise ValueError(f"lb_fused runs on cuda or cpu, got {cands.device}")
    return lb_fused_launch(cands, qs, upper, lower, w, bounds, p, tile_b, depth, grid)
