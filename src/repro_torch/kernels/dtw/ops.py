"""Banded DTW: the K5 CUDA kernel's wrappers and plain version.

The kernel (``csrc/dtw.cu``) replaces the TPU kernel
``repro/kernels/dtw/kernel.py::dtw_banded_pallas``.  It takes (query,
candidate) pairs as the dense (Q, B) grid or as explicit (qidx, cidx)
index lists into the query and candidate rows, and gathers the rows
itself, so the drivers build no (chunk, n) copies.  Rows too long for
the kernel's shared memory take its long-row path, chosen by shape in
the kernel (the rows read in place, the diagonals in a workspace that
the wrapper allocates where they too overflow).  Per-lane powered
``bounds`` (the cascade's running k-th best) let a lane abandon: it then
returns a value >= its bound instead of the exact distance.  Omitted,
every lane runs the full DP.  p in {1, 2, inf}, float32 and float64.

A masked-dense entry serves the host driver's device-resident block
loop: slot (q, b) of a (Q, B) grid runs query q against candidate row b
only where K4's stage is the survivors' code (the pipeline's number of
LB stages, 2 or 3; the rows of the merge's counts give it), with query
q's bound read from a strided
column (the running k-th best); the other slots are neither read nor
written.  The same launch ends with the block's merge into the loop's
top-k and counters (``csrc/block_merge.cuh``, the routine of the
standalone merge kernel): the last block of each query merges it, so
the loop runs two launches per block, K4 and this one.
``dtw_masked_prepare``, its one host path, checks the buffers once and
returns a launcher that the loop calls once per block;
``dtw_merge_launch`` is one call of it.

Two plain versions sit beside it.  ``dtw_plain`` is the reference's
semantics (row DP, an abandoned lane returns its row minimum); the CPU
route takes it.  ``dtw_wavefront_plain`` repeats the kernel's own
anti-diagonal DP and abandon rule, so the kernel is bit-equal to it on
every lane, finished or abandoned.

Every entry takes a channel count ``d``: with ``d > 1`` the rows are
dependent multivariate series, channel-major flattened to (d*n,)
(``repro_torch.mv.layout``), the band runs over the n x n cells and a
cell's cost is the channel sum of the per-channel costs (the max at
p = inf), as ``repro_torch.mv.dtw`` computes it.  The kernel then takes
its channel paths (``csrc/dtw.cu``, the channel entry), and its launches
count as ``dtw_mv`` and ``dtw_merge_mv``; d = 1 launches the univariate
instantiations, counted as ``dtw`` and ``dtw_merge``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.dtw import (
    BIG,
    _dtw_rows_early,
    dtw_banded_diag,
    elem_cost,
    finish_cost,
)
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.block_merge.ops import block_merge_plain, check_merge_buffers
from repro_torch.kernels.common import (
    check_cuda_tensor,
    count_launch,
    kernel_dtype,
    p_code,
)


def _segment(qs, d: int) -> int:
    """Per-channel length n of the (Q, d*n) rows."""
    total = qs.shape[1]
    if d < 1 or total % d:
        raise ValueError(f"row length {total} not a multiple of d={d}")
    return total // d


def dtw_plain(qs, cands, w: int, p=1, qidx=None, cidx=None, bounds=None, d: int = 1):
    """Plain PyTorch version: powered DTW, (Q, B) dense or (P,) for pair
    lists.  At p = inf it is the anti-diagonal DP of
    ``core.dtw.dtw_banded_diag`` and ignores ``bounds`` (an exact value
    meets the abandon contract); ``d > 1``: the dependent DP of
    ``repro_torch.mv.dtw``."""
    w = int(min(w, _segment(qs, d) - 1))
    qrows, crows, lead = _pair_rows(qs, cands, qidx, cidx)
    if d > 1:
        # imported here: repro_torch.mv imports the index, which imports this module
        from repro_torch.mv.dtw import _diag_mv, _dtw_rows_early_mv
    if p == math.inf:
        out = (_diag_mv(qrows, crows, w, p, d) if d > 1
               else dtw_banded_diag(qrows, crows, w, p, powered=True))
    else:
        if bounds is None:
            bound = torch.full((qrows.shape[0],), BIG, dtype=qs.dtype, device=qs.device)
        else:
            bound = bounds.reshape(-1)
        out = (_dtw_rows_early_mv(qrows, crows, w, bound, p, d) if d > 1
               else _dtw_rows_early(qrows, crows, w, bound, p))
    return out.reshape(lead)


#: steps between two abandon tests of the kernel (csrc/dtw.cu ABANDON_EVERY)
ABANDON_EVERY = 32


def _pair_rows(qs, cands, qidx, cidx):
    """(P, row) query and candidate rows of the pairs, and the output shape."""
    n = qs.shape[1]
    if qidx is None:
        nq, b = qs.shape[0], cands.shape[0]
        qrows = qs[:, None, :].expand(nq, b, n).reshape(nq * b, n)
        crows = cands[None, :, :].expand(nq, b, n).reshape(nq * b, n)
        return qrows, crows, (nq, b)
    return qs[qidx], cands[cidx], (qidx.shape[0],)


def dtw_wavefront_plain(qs, cands, w: int, p=1, qidx=None, cidx=None, bounds=None,
                        d: int = 1):
    """Plain PyTorch version of the kernel's DP, bit for bit: the
    anti-diagonal wavefront over the w+1 slots of a diagonal's parity
    (slot t is offset i - j = -w + par + 2t, par = (s + w) % 2), with the
    kernel's cell arithmetic (at ``d > 1`` the channel costs joined in
    channel order).  With ``bounds``, before step 0 and every
    ``ABANDON_EVERY`` steps a lane whose minimum over its two latest
    diagonals is >= its bound stops and returns that minimum.  Without
    bounds it equals ``core.dtw.dtw_banded_diag(..., powered=True)`` (at
    d > 1, ``mv.dtw.dtw_banded_diag_mv``)."""
    n = _segment(qs, d)
    w = int(min(w, n - 1))
    qrows, crows, lead = _pair_rows(qs, cands, qidx, cidx)
    npair, dt, dev = qrows.shape[0], qs.dtype, qs.device
    q3, c3 = qrows.reshape(npair, d, n), crows.reshape(npair, d, n)
    slots = torch.arange(w + 1, device=dev)
    big_col = torch.full((npair, 1), BIG, dtype=dt, device=dev)
    older = torch.full((npair, w + 1), BIG, dtype=dt, device=dev)  # diagonal s-2
    older[:, w // 2] = 0.0  # the diag predecessor of cell (0, 0)
    newer = torch.full_like(older, BIG)  # diagonal s-1
    bound = None if bounds is None else bounds.reshape(-1)
    live = torch.ones(npair, dtype=torch.bool, device=dev)
    stopped_at = torch.zeros(npair, dtype=dt, device=dev)
    for s in range(2 * n - 1):
        if bound is not None and s % ABANDON_EVERY == 0:
            m = torch.minimum(older.min(dim=1).values, newer.min(dim=1).values)
            stop = live & (m >= bound)
            stopped_at = torch.where(stop, m, stopped_at)
            live = live & ~stop
        par = (s + w) % 2
        i = (s - w + par) // 2 + slots
        j = (s + w - par) // 2 - slots
        ok = (i >= 0) & (i < n) & (j >= 0) & (j < n) & (slots <= w - par)
        qv, cv = q3[:, :, i.clamp(0, n - 1)], c3[:, :, j.clamp(0, n - 1)]
        cost = elem_cost(qv[:, 0] - cv[:, 0], p)
        for ch in range(1, d):
            c_ch = elem_cost(qv[:, ch] - cv[:, ch], p)
            cost = torch.maximum(cost, c_ch) if p == math.inf else cost + c_ch
        if par == 0:
            up, left = torch.cat([big_col, newer[:, :-1]], dim=1), newer
        else:
            up, left = newer, torch.cat([newer[:, 1:], big_col], dim=1)
        best = torch.minimum(torch.minimum(up, left), older)
        val = torch.maximum(cost, best) if p == math.inf else cost + best
        val = torch.where(ok, val.clamp(max=BIG), torch.full_like(val, BIG))
        older, newer = newer, val
    out = torch.where(live, newer[:, w // 2], stopped_at)
    return out.reshape(lead)


def dtw_launch(qs, cands, w: int, p=1, qidx=None, cidx=None, bounds=None, d: int = 1):
    """Launch K5 on CUDA tensors; shapes follow dtw_plain.  ``d > 1``
    launches the channel entry (counted as ``dtw_mv_launch``)."""
    dev, dt = qs.device, qs.dtype
    nq, total = qs.shape
    n = _segment(qs, d)
    w = int(min(w, n - 1))
    check_cuda_tensor("qs", qs, dev, dt)
    check_cuda_tensor("cands", cands, dev, dt, (cands.shape[0], total))
    if qidx is None:
        npairs, lead = nq * cands.shape[0], (nq, cands.shape[0])
    else:
        npairs, lead = qidx.shape[0], (qidx.shape[0],)
        check_cuda_tensor("qidx", qidx, dev, torch.int64, (npairs,))
        check_cuda_tensor("cidx", cidx, dev, torch.int64, (npairs,))
    if bounds is not None:
        check_cuda_tensor("bounds", bounds, dev, dt, lead)
    out = torch.empty(lead, dtype=dt, device=dev)
    ws = cuda_lib.workspace("dtw", dev, kernel_dtype(qs), npairs, n, w, d)
    code = cuda_lib.library().repro_dtw(
        kernel_dtype(qs), p_code(p), qs.data_ptr(), cands.data_ptr(),
        cuda_lib.ptr(qidx), cuda_lib.ptr(cidx), cuda_lib.ptr(bounds), npairs,
        cands.shape[0], n, w, d, out.data_ptr(), cuda_lib.ptr(ws), cuda_lib.stream_of(dev),
    )
    cuda_lib.check("dtw", code)
    if npairs:
        count_launch(dtw_launch if d == 1 else dtw_mv_launch)
    return out


dtw_launch.launches = 0


def dtw_mv_launch(qs, cands, w: int, p=1, qidx=None, cidx=None, bounds=None, d: int = 2):
    """K5's channel entry on CUDA tensors: ``dtw_launch`` at ``d > 1``
    channels (rows (., d*n)), which counts its launches here."""
    if d < 2:
        raise ValueError(f"the channel entry takes d > 1 channels, got d={d}")
    return dtw_launch(qs, cands, w, p, qidx, cidx, bounds, d)


dtw_mv_launch.launches = 0


def dtw_masked_plain(qs, cands, stage, w: int, p=1, bounds=None, out=None,
                     dp=dtw_plain, live: int = 2, d: int = 1):
    """Plain version of the masked-dense entry: out[q, b] = ``dp`` of
    query q against cands[b] where stage[q, b] == ``live``, with bound
    bounds[q] (a (Q,) tensor, any stride); other slots of ``out`` (Q, B)
    keep their values.  ``dp`` is ``dtw_plain`` (the CPU route) or
    ``dtw_wavefront_plain`` (the kernel's own arithmetic)."""
    nq, nb = stage.shape
    if out is None:
        out = torch.empty((nq, nb), dtype=qs.dtype, device=qs.device)
    qi, ci = (stage == live).nonzero(as_tuple=True)
    if qi.numel():
        b = None if bounds is None else bounds.reshape(-1)[qi]
        out[qi, ci] = dp(qs, cands, w, p, qi, ci, b, d=d)
    return out


def dtw_merge_plain(qs, cands, stage, w: int, p, bounds, out, top_v, top_i, counts,
                    totals, lo: int, dtw_chunk: int, dp=dtw_plain, d: int = 1):
    """Plain version of the masked-dense entry with the merge:
    ``dtw_masked_plain`` into ``out`` on the survivors' code that the
    rows of ``counts`` give (n_lb + 1), then ``block_merge_plain`` of the
    block starting at database row ``lo``, all in place."""
    dtw_masked_plain(qs, cands, stage, w, p, bounds, out, dp, counts.shape[0] - 1, d)
    block_merge_plain(top_v, top_i, counts, totals, stage, out, lo, dtw_chunk)
    return out


def dtw_masked_prepare(qs, w: int, p, stage, bounds, out, merge, d: int = 1):
    """K5's masked-dense entry with the merge, for launches on blocks of
    candidate rows: checks the queries, the ``stage`` and ``out`` buffers
    (Q, B), ``bounds`` (a (Q,) tensor of any stride read at each launch,
    or None) and ``merge`` = ``(top_v, top_i, counts, totals,
    dtw_chunk)``, the buffers of ``block_merge_plain`` (counts (n_lb + 1,
    Q): the survivors' stage is n_lb), once and returns
    ``run(cands, lo=0)`` -> ``out``.  Each launch runs the DP of the live
    slots into ``out``, then merges the block, whose first candidate is
    database row ``lo``, into the merge buffers (bounds may be a column
    of top_v: every DP of a launch reads its bound before the merge of
    its query writes it).  ``d > 1``: rows of d channels, the channel
    entry (launches counted as ``dtw_merge_mv_launch``).  On CPU tensors
    ``run`` is ``dtw_merge_plain``: ``dtw_masked_plain`` then
    ``block_merge_plain``."""
    nq, total = qs.shape
    n = _segment(qs, d)
    w = int(min(w, n - 1))
    dev, dt = qs.device, qs.dtype
    top_v, top_i, counts, totals, dtw_chunk = merge
    if dev.type == "cpu":
        return lambda cands, lo=0: dtw_merge_plain(qs, cands, stage, w, p, bounds, out,
                                                   top_v, top_i, counts, totals, lo,
                                                   dtw_chunk, d=d)
    if dev.type != "cuda":
        raise ValueError(f"dtw runs on cuda or cpu, got {dev}")
    nb = stage.shape[1]
    check_cuda_tensor("qs", qs, dev, dt)
    check_cuda_tensor("stage", stage, dev, torch.uint8, (nq, nb))
    check_cuda_tensor("out", out, dev, dt, (nq, nb))
    bstride = 0
    if bounds is not None:
        if bounds.device != dev or bounds.dtype != dt or tuple(bounds.shape) != (nq,):
            raise ValueError(f"bounds must be ({nq},) {dt} on {dev}")
        bstride = max(int(bounds.stride(0)), 1)
    check_merge_buffers(top_v, top_i, counts, totals, nq, dt, dev, dtw_chunk)
    # the merge epilogue's tickets, one per query, then the long-row
    # path's diagonals where they overflow shared memory
    diag = int(cuda_lib.library().repro_dtw_workspace(kernel_dtype(qs), nq * nb, n, w, d))
    workspace = torch.zeros(nq + -(-diag // 8), dtype=torch.int64, device=dev)
    fn = cuda_lib.library().repro_dtw_masked
    head = (kernel_dtype(qs), p_code(p), qs.data_ptr())
    mid = (stage.data_ptr(), cuda_lib.ptr(bounds), bstride, nq, nb, n, w, d, out.data_ptr(),
           top_v.data_ptr(), top_i.data_ptr(), top_v.shape[1])
    tail = (int(dtw_chunk), counts.shape[0] - 1, counts.data_ptr(), totals.data_ptr(),
            workspace.data_ptr(), cuda_lib.stream_of(dev))
    counter = dtw_merge_launch if d == 1 else dtw_merge_mv_launch

    def run(cands, lo=0):
        check_cuda_tensor("cands", cands, dev, dt, (nb, total))
        cuda_lib.check("dtw", fn(*head, cands.data_ptr(), *mid, int(lo), *tail))
        if nq * nb:
            count_launch(counter)
        return out

    run.tensors = (qs, stage, bounds, out, top_v, top_i, counts, totals,
                   workspace)  # the pointers it holds
    return run


def dtw_merge_launch(qs, cands, stage, w: int, p, bounds, out, top_v, top_i, counts,
                     totals, lo: int, dtw_chunk: int, d: int = 1):
    """Launch K5's masked-dense entry with the merge once on CUDA tensors,
    through ``dtw_masked_prepare``; arguments follow dtw_merge_plain."""
    check_cuda_tensor("qs", qs, qs.device, qs.dtype)
    merge = (top_v, top_i, counts, totals, dtw_chunk)
    return dtw_masked_prepare(qs, w, p, stage, bounds, out, merge, d)(cands, lo)


dtw_merge_launch.launches = 0


def dtw_merge_mv_launch(qs, cands, stage, w: int, p, bounds, out, top_v, top_i, counts,
                        totals, lo: int, dtw_chunk: int, d: int = 2):
    """K5's masked-dense channel entry with the merge, once: ``d > 1``
    channels; its launches are counted here."""
    if d < 2:
        raise ValueError(f"the channel entry takes d > 1 channels, got d={d}")
    return dtw_merge_launch(qs, cands, stage, w, p, bounds, out, top_v, top_i, counts,
                            totals, lo, dtw_chunk, d)


dtw_merge_mv_launch.launches = 0


def _dispatch(qs, cands, w, p, qidx, cidx, bounds, d):
    if qs.device.type == "cpu":
        return dtw_plain(qs, cands, w, p, qidx, cidx, bounds, d)
    if qs.device.type != "cuda":
        raise ValueError(f"dtw runs on cuda or cpu, got {qs.device}")
    return dtw_launch(qs, cands, w, p, qidx, cidx, bounds, d)


def dtw_qbatch_op(qs, cands, w: int, p=1, bounds=None, d: int = 1):
    """Powered DTW of queries (Q, d*n) x candidates (B, d*n) -> (Q, B)."""
    return _dispatch(qs, cands, w, p, None, None, bounds, int(d))


def dtw_pairs_op(qs, cands, qidx, cidx, w: int, p=1, bounds=None, d: int = 1):
    """Powered DTW of the pairs (qs[qidx[i]], cands[cidx[i]]) -> (P,)."""
    return _dispatch(qs, cands, w, p, qidx, cidx, bounds, int(d))


def dtw_op(q, cands, w: int, p=1, powered: bool = False, bounds=None, d: int = 1):
    """DTW_p of query (d*n,) against candidates (B, d*n) -> (B,), as the
    reference's ``dtw_op``; ``bounds`` (B,) are powered abandon bounds."""
    b = None if bounds is None else bounds.reshape(1, -1)
    out = dtw_qbatch_op(q[None, :], cands, w, p, b, d)[0]
    return out if powered else finish_cost(out, p)
