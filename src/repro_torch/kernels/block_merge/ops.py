"""The host driver's per-block top-k merge and counters: the block_merge
CUDA kernel's wrappers and plain version.

The kernel (``csrc/block_merge.cu``) replaces no TPU kernel: it stands
for the reference's host merge, ``repro/core/cascade.py::nn_search_host``
(``merge``, a stable numpy argsort of a query's top-k followed by the DP
values of its survivors).  It keeps the device-resident block loop of
``repro_torch.core.cascade`` on the card.  For one block of B candidate
rows starting at database row ``lo``, given K4's ``stage`` (Q, B) and
K5's DP values ``dvals`` (Q, B), read only where the stage is the
survivors' code, it updates in place:

* ``top_v``/``top_i`` (Q, k): the stable top-k of [top-k, survivors in
  row order], so an equal value never displaces an entry and a lower row
  wins a tie;
* ``counts`` (n_lb + 1, Q) int64: per query, the pairs pruned by each of
  the pipeline's n_lb LB stages (2: LB_Keogh, LB_Improved; 3: LB_Kim
  first), then the survivors.  Its rows give n_lb: stage s < n_lb is a
  pair pruned by LB stage s, stage n_lb a survivor, 255 a pad row;
* ``totals`` (4,) int64: blocks_lb2 (1 if any real pair survived the
  first LB stage), blocks_dtw (ceil(S / dtw_chunk) for S survivors),
  dp_lane_work (dtw_chunk times that) and dp_lane_useful (S).

The plain version is a torch stable sort; the kernel is bit-equal to it.
On the host driver's loop the same routine runs as the epilogue of K5's
masked entry (``kernels/dtw/ops.py::dtw_masked_prepare`` with ``merge``);
this kernel runs it alone, as its yardstick and check.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import check_cuda_tensor, count_launch, kernel_dtype


def block_merge_plain(top_v, top_i, counts, totals, stage, dvals, lo: int,
                      dtw_chunk: int):
    """Plain PyTorch version: a stable argsort merge and tensor counters,
    in place (no host synchronisation)."""
    nq, k = top_v.shape
    nb = stage.shape[1]
    n_lb = counts.shape[0] - 1
    live = stage == n_lb
    cand = torch.where(live, dvals.reshape(nq, nb), math.inf)
    rows = torch.arange(lo, lo + nb, dtype=torch.int64, device=top_i.device)
    all_v = torch.cat([top_v, cand.to(top_v.dtype)], dim=1)
    all_i = torch.cat([top_i, rows.expand(nq, nb)], dim=1)
    sel = torch.argsort(all_v, dim=1, stable=True)[:, :k]
    top_v.copy_(torch.gather(all_v, 1, sel))
    top_i.copy_(torch.gather(all_i, 1, sel))
    per_query = torch.stack([(stage == j).sum(dim=1) for j in range(n_lb + 1)])
    counts += per_query
    s = per_query[n_lb].sum()
    chunks = (s + dtw_chunk - 1) // dtw_chunk
    any_lb2 = per_query[1:].sum().gt(0).to(torch.int64)
    totals += torch.stack([any_lb2, chunks, chunks * dtw_chunk, s])


def check_merge_buffers(top_v, top_i, counts, totals, nq: int, dtype, device,
                        dtw_chunk: int):
    """Validate the top-k and counters of a merge on the card; raise
    rather than launch on them."""
    k = top_v.shape[-1]
    check_cuda_tensor("top_v", top_v, device, dtype, (nq, k))
    check_cuda_tensor("top_i", top_i, device, torch.int64, (nq, k))
    if counts.dim() != 2 or counts.shape[0] not in (3, 4):
        raise ValueError(f"counts must be (n_lb + 1, {nq}) with 2 or 3 LB stages, "
                         f"got {tuple(counts.shape)}")
    check_cuda_tensor("counts", counts, device, torch.int64, (counts.shape[0], nq))
    check_cuda_tensor("totals", totals, device, torch.int64, (4,))
    if k < 1 or int(dtw_chunk) < 1:
        raise ValueError(f"k={k} and dtw_chunk={dtw_chunk} must be >= 1")


def block_merge_prepare(top_v, top_i, counts, totals, stage, dvals,
                        dtw_chunk: int):
    """The merge for launches on blocks: checks every buffer once and
    returns ``run(lo)``, the merge of the block starting at database row
    ``lo``.  On CPU tensors ``run`` is the plain version."""
    dev, dt = top_v.device, top_v.dtype
    if dev.type == "cpu":
        return lambda lo: block_merge_plain(top_v, top_i, counts, totals, stage,
                                            dvals, lo, dtw_chunk)
    if dev.type != "cuda":
        raise ValueError(f"block_merge runs on cuda or cpu, got {dev}")
    nq, k = top_v.shape
    nb = stage.shape[1]
    check_merge_buffers(top_v, top_i, counts, totals, nq, dt, dev, dtw_chunk)
    check_cuda_tensor("stage", stage, dev, torch.uint8, (nq, nb))
    check_cuda_tensor("dvals", dvals, dev, dt, (nq, nb))
    fn = cuda_lib.library().repro_block_merge
    head = (kernel_dtype(top_v), top_v.data_ptr(), top_i.data_ptr(), k,
            stage.data_ptr(), dvals.data_ptr(), nq, nb)
    tail = (int(dtw_chunk), counts.shape[0] - 1, counts.data_ptr(), totals.data_ptr(),
            cuda_lib.stream_of(dev))

    def run(lo):
        cuda_lib.check("block_merge", fn(*head, int(lo), *tail))
        if nq:
            count_launch(block_merge_launch)

    run.tensors = (top_v, top_i, counts, totals, stage, dvals)  # the pointers it holds
    return run


def block_merge_launch(top_v, top_i, counts, totals, stage, dvals, lo: int,
                       dtw_chunk: int):
    """Launch the merge kernel once on CUDA tensors, through
    ``block_merge_prepare``; arguments follow block_merge_plain."""
    check_cuda_tensor("top_v", top_v, top_v.device, top_v.dtype)
    block_merge_prepare(top_v, top_i, counts, totals, stage, dvals, dtw_chunk)(lo)


block_merge_launch.launches = 0
