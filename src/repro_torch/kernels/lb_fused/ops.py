"""Fused LB_Keogh -> LB_Improved: the K4 CUDA kernel's wrappers and plain
versions.

The kernel (``csrc/lb_fused.cu``) replaces the TPU kernel
``repro/kernels/lb_fused/kernel.py::lb_fused_qbatch_pallas``.  For
candidates (B, n) against queries (Q, n) with their envelopes and a
powered pruning bound per query, it returns (lb1, lb) of shape (Q, B):
LB_Keogh for every lane, and the full LB_Improved where lb1 < bound
(lb == lb1 elsewhere), and optionally each pair's cascade ``stage``
(``lb_fused_stage_plain``).  It runs one warp per (query, candidate)
pair: pass 2 of every live pair runs at once, and a dead pair skips it.
Its kim entry (``kim=True``) puts LB_Kim first, the cascade
``kim_improved`` at p in {1, 2}: the queries' features come from K6's
feature phase once per prepared launcher, the candidate's max and min
from pass 1's own sweep; a pair whose LB_Kim is >= the bound gets stage
0 and skips pass 2 (lb == lb1), and the other stages move up by one.
The projections H stay in shared memory.  lb1 is bit-equal to K2's
LB_Keogh and lb to K2's plus K3's pass 2, the two kernels the host
driver would otherwise launch (``csrc/lb_routines.cuh``).

The reference op serves p in {1, 2} only and raises otherwise; so does
this one.  A ragged B needs no padding: the kernel masks the last tile,
so no pad lane can keep pass 2 alive (the reason the reference pads with
``PAD_VALUE`` rather than zeros).

``tile_b`` (pairs, that is warps, per block), ``grid`` (``"qb"``: a block
per (query, tile of candidates); ``"bq"``: a block per tile, each warp
staging its candidate row once and looping over the queries) and
``depth`` left ``None`` resolve from the active tune table; none changes
an output bit.  The kernel has no ``cp.async`` double buffering, so
``depth=2`` cannot launch.  A resolved tile too large for shared memory
at this length is halved until it fits; an explicit one raises
:class:`~repro_torch.kernels.common.NotRunnable`.  Rows whose one warp's
buffers overflow shared memory (``fused_long``) take the kernel's
long-row path at any tile: H and pass 2's buffers in a workspace that
``lb_fused_prepare`` allocates once, pass 2 K3's own routine.

``lb_fused_prepare`` is the one host path to the kernel: it checks and
resolves everything once and returns a launcher that only passes a
block's rows to the kernel.  The host driver's device-resident block
loop calls that launcher once per block; ``lb_fused_launch`` is one
call of it.

Multivariate rows (``d > 1``, channel-major flattened with per-segment
envelopes) do what the reference op does: K4 stays the d = 1 kernel, and
the two passes are composed instead, K2 on the flat rows, then K3 with
the channels folded into its rows (``lb_improved_pass2_qbatch_op(d=)``),
``lb = where(lb1 < bound, lb1 + lb2, lb1)``; the prepared launcher also
writes the stages (0/1/2, 255 for pad rows) on the device against the
device-resident bound, with no synchronisation.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import (
    SMEM_LIMIT_BYTES,
    NotRunnable,
    check_cuda_tensor,
    count_launch,
    kernel_dtype,
    p_code,
)
from repro_torch.kernels.lb_improved.ops import (
    combine_passes,
    lb_improved_pass2_plain,
    lb_improved_pass2_qbatch_op,
)
from repro_torch.kernels.lb_keogh.ops import lb_keogh_plain, lb_keogh_qbatch_op
from repro_torch.kernels.lb_kim.ops import lb_kim_features_launch, lb_kim_plain
from repro_torch.kernels.tuning.space import GRID_LAYOUTS
from repro_torch.kernels.tuning.table import resolve_config

#: ``stage`` value of a candidate row at or past ``real`` (a pad row)
PAD_STAGE = 255


def _check_p(p):
    if p not in (1, 2):
        raise ValueError("kernel fast path supports p in {1, 2}")


def lb_fused_plain(cands, qs, upper, lower, w: int, bounds, p=1, kim=None):
    """Plain PyTorch version: K2's and K3's plain versions, pass 2 kept
    where lb1 < bound -> (lb1 (Q, B), lb (Q, B)).  ``kim`` (Q, B), the
    pairs' LB_Kim of the kim entry, keeps pass 2 only where it is < bound
    too."""
    _check_p(p)
    w = int(min(w, cands.shape[-1] - 1))
    lb1, h = lb_keogh_plain(cands, upper, lower, p)
    lb2 = lb_improved_pass2_plain(h, qs, w, p)
    b = bounds.reshape(-1, 1)
    alive = lb1 < b if kim is None else (kim < b) & (lb1 < b)
    return lb1, torch.where(alive, combine_passes(lb1, lb2, p), lb1)


def lb_fused_stage_plain(lb1, lb, bounds, real: int | None = None, kim=None):
    """Each pair's cascade stage (Q, B) uint8 from K4's outputs: 0 pruned
    by LB_Keogh (lb1 >= bound), 1 pruned by LB_Improved (lb >= bound), 2
    a survivor; candidates at or past ``real`` get ``PAD_STAGE``.  With
    ``kim`` (Q, B), the pairs' LB_Kim, LB_Kim comes first: 0 pruned by
    it (kim >= bound), then 1, 2 and 3 for the stages above."""
    b = bounds.reshape(-1, 1)
    stage = torch.where(lb1 < b, torch.where(lb < b, 2, 1), 0)
    if kim is not None:
        stage = torch.where(kim < b, stage + 1, 0)
    stage = stage.to(torch.uint8)
    if real is not None and real < stage.shape[1]:
        stage[:, real:] = PAD_STAGE
    return stage


def fused_smem_bytes(n: int, w: int, tile_b: int, grid: str, itemsize: int) -> int:
    """Shared memory of one K4 block: per warp its H row (and its staged
    candidate row for ``"bq"``) and the pass-2 envelope buffer."""
    row = n * (2 if grid == "bq" else 1)
    return itemsize * tile_b * (row + 4 * (n + 2 * w))


def fused_long(n: int, w: int, grid: str, itemsize: int) -> bool:
    """Whether a launch takes K4's long-row path (``csrc/lb_fused.cu``
    fused_long): one warp's buffers overflow a block's shared memory, so
    they go to a workspace, at any ``tile_b``."""
    return fused_smem_bytes(n, w, 1, grid, itemsize) > SMEM_LIMIT_BYTES


def _schedule(nb, n, w, itemsize, tile_b, depth, grid) -> tuple[int, str]:
    """(warps per block, grid) of a launch: ``None`` knobs from the tune
    table, a resolved tile halved until it fits in shared memory.  On the
    long-row path (``fused_long``) every tile fits."""
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
            "buffering (ROADMAP.md queue 2)"
        )
    tile_b = int(tile_b)
    if not 1 <= tile_b <= 32:
        raise NotRunnable(f"tile_b={tile_b} warps per block is outside 1..32")
    if fused_long(n, w, grid, itemsize):
        return tile_b, grid
    while fused_smem_bytes(n, w, tile_b, grid, itemsize) > SMEM_LIMIT_BYTES:
        if not shrink or tile_b == 1:
            raise NotRunnable(
                f"lb_fused tile_b={tile_b} grid={grid!r} needs "
                f"{fused_smem_bytes(n, w, tile_b, grid, itemsize)} bytes "
                f"of shared memory at n={n}, w={w}; the limit is {SMEM_LIMIT_BYTES}"
            )
        tile_b //= 2
    return tile_b, grid


def _check_bounds(bounds, dev, dt, nq):
    """The bounds may be a strided column (of a top-k); the kernel reads
    bounds[q * stride]."""
    if bounds.device != dev or bounds.dtype != dt or tuple(bounds.shape) != (nq,):
        raise ValueError(
            f"bounds must be ({nq},) {dt} on {dev}, got {tuple(bounds.shape)} "
            f"{bounds.dtype} on {bounds.device}"
        )
    return max(int(bounds.stride(0)), 1)


def lb_fused_composed(cands, qs, upper, lower, w: int, bounds, p, d: int):
    """Both passes for channel-major flattened rows of ``d > 1`` channels:
    K2 on the flat rows, the folded K3, and pass 2 kept where lb1 < bound
    -> (lb1 (Q, B), lb (Q, B)); the plain versions on CPU tensors."""
    lb1, h = lb_keogh_qbatch_op(cands, upper, lower, p)
    lb2 = lb_improved_pass2_qbatch_op(h, qs, w, p, d)
    return lb1, torch.where(lb1 < bounds.reshape(-1, 1), lb1 + lb2, lb1)


def lb_fused_prepare(qs, upper, lower, w: int, bounds, p, block: int, stage=None,
                     tile_b=None, depth=None, grid=None, kim: bool = False, d: int = 1):
    """K4 for launches on blocks of ``block`` candidate rows: checks the
    queries, envelopes, ``bounds`` (a (Q,) tensor of any stride, read at
    each launch) and the optional ``stage`` buffer (Q, block) uint8 once,
    resolves the schedule once, and returns ``run(cands, real=block)`` ->
    (lb1, lb), two (Q, block) buffers it reuses; ``run`` also writes the
    block's stage (rows past ``real`` are pad rows).  ``kim`` takes the
    kim entry, whose query features K6's feature phase computes here,
    once.  On CPU tensors ``run`` is the plain version
    (``lb_kim_plain``, then ``lb_fused_plain`` and
    ``lb_fused_stage_plain``).  ``d > 1`` (no kim entry) composes K2 and
    the folded K3 (``lb_fused_composed``) and writes the stages with
    tensor operations on the same device."""
    _check_p(p)
    dev, dt = qs.device, qs.dtype
    nq, n = qs.shape
    if bounds.dim() != 1:
        bounds = bounds.reshape(-1)
    if int(d) > 1:
        if kim:
            raise ValueError("K4's kim entry serves d = 1 rows only")

        def run_composed(cands, real=block):
            lb1, lb = lb_fused_composed(cands, qs, upper, lower, w, bounds, p, int(d))
            if stage is not None:
                stage.copy_(lb_fused_stage_plain(lb1, lb, bounds, real))
            return lb1, lb

        return run_composed
    w = int(min(w, n - 1))
    if dev.type == "cpu":
        def run_plain(cands, real=block):
            kim_lb = lb_kim_plain(cands, qs, None, p) if kim else None
            lb1, lb = lb_fused_plain(cands, qs, upper, lower, w, bounds, p, kim_lb)
            if stage is not None:
                stage.copy_(lb_fused_stage_plain(lb1, lb, bounds, real, kim_lb))
            return lb1, lb

        return run_plain
    if dev.type != "cuda":
        raise ValueError(f"lb_fused runs on cuda or cpu, got {dev}")
    for name, t in (("qs", qs), ("upper", upper), ("lower", lower)):
        check_cuda_tensor(name, t, dev, dt, (nq, n))
    if stage is not None:
        check_cuda_tensor("stage", stage, dev, torch.uint8, (nq, block))
    bstride = _check_bounds(bounds, dev, dt, nq)
    tile_b, grid = _schedule(block, n, w, qs.element_size(), tile_b, depth, grid)
    lb1 = torch.empty((nq, block), dtype=dt, device=dev)
    lb = torch.empty((nq, block), dtype=dt, device=dev)
    qfeat = lb_kim_features_launch(qs) if kim else None
    # the long-row path's buffers, allocated once for every launch
    ws = cuda_lib.workspace("lb_fused", dev, kernel_dtype(qs), nq, block, n, w, tile_b,
                            int(grid == "bq"))
    fn = cuda_lib.library().repro_lb_fused
    head = (kernel_dtype(qs), p_code(p))
    mid = (qs.data_ptr(), upper.data_ptr(), lower.data_ptr(), bounds.data_ptr(),
           bstride, cuda_lib.ptr(qfeat), nq, block, n, w, tile_b, int(grid == "bq"))
    tail = (lb1.data_ptr(), lb.data_ptr(), cuda_lib.ptr(stage), cuda_lib.ptr(ws),
            cuda_lib.stream_of(dev))

    def run(cands, real=block):
        check_cuda_tensor("cands", cands, dev, dt, (block, n))
        code = fn(*head, cands.data_ptr(), *mid, int(real), *tail)
        cuda_lib.check("lb_fused", code)
        if nq * block:
            count_launch(lb_fused_launch)
        return lb1, lb

    run.tensors = (qs, upper, lower, bounds, stage, lb1, lb, ws, qfeat)  # the pointers it holds
    return run


def lb_fused_launch(cands, qs, upper, lower, w: int, bounds, p=1, tile_b=None,
                    depth=None, grid=None, *, stage: bool = False,
                    real: int | None = None, kim: bool = False):
    """Launch K4 once on CUDA tensors, through ``lb_fused_prepare``;
    shapes follow lb_fused_plain.  With ``stage`` it returns (lb1, lb,
    stage) as ``lb_fused_stage_plain`` derives it; ``real`` (default B)
    marks the rows past it as pad rows; ``kim`` takes the kim entry."""
    check_cuda_tensor("qs", qs, cands.device, cands.dtype)
    nq, nb = qs.shape[0], cands.shape[0]
    st = torch.empty((nq, nb), dtype=torch.uint8, device=qs.device) if stage else None
    run = lb_fused_prepare(qs, upper, lower, w, bounds, p, nb, st, tile_b, depth, grid,
                           kim)
    lb1, lb = run(cands, nb if real is None else int(real))
    return (lb1, lb, st) if stage else (lb1, lb)


lb_fused_launch.launches = 0


def lb_fused_qbatch_op(cands, qs, upper, lower, w: int, bounds, p=1, tile_b=None,
                       depth=None, grid=None, d: int = 1):
    """Both passes of the two-pass bound in one launch: candidates (B, n)
    vs queries (Q, n) with envelopes (Q, n) and per-query powered
    ``bounds`` (Q,) -> (lb1 (Q, B), lb (Q, B)), lb == lb1 on lanes with
    lb1 >= bound.  ``d > 1``: channel-major flattened rows, the two passes
    composed (``lb_fused_composed``)."""
    _check_p(p)
    if int(d) > 1:
        return lb_fused_composed(cands, qs, upper, lower, w, bounds, p, int(d))
    if cands.device.type == "cpu":
        return lb_fused_plain(cands, qs, upper, lower, w, bounds, p)
    if cands.device.type != "cuda":
        raise ValueError(f"lb_fused runs on cuda or cpu, got {cands.device}")
    return lb_fused_launch(cands, qs, upper, lower, w, bounds, p, tile_b, depth, grid)
