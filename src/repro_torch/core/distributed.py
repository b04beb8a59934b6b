"""Sharded DTW nearest-neighbour search — the paper's parallel postscript.

Port of ``repro.core.distributed``.  The paper's conclusion: *"Several
instances of Algo. 3 can run in parallel as long as they can communicate
the distance between the time series and the best candidate."*

* The candidate database shards over (any subset of) the axes of a
  :class:`Mesh`, one ``torch.distributed`` rank per device.  The
  reference runs one controller over S devices under ``shard_map``; here
  every rank is a process of its own, calls :func:`sharded_nn_search`
  with the same queries and the same padded database, sweeps its own
  rows ``[r * n_local, (r + 1) * n_local)`` on its own device, and
  returns the same merged result as every other rank.
* Each shard runs the scan driver's block body
  (``core.cascade.make_block_step``) over its rows, the whole ``(Q, n)``
  query batch sharing each block.  Every ``sync_every`` blocks the
  shards exchange each query's k-th best with ``all_reduce(MIN)``, and
  every block prunes against the lower of its own k-th best and that
  exchanged bound.
* At the end the per-shard top-k lists are all-gathered in shard order
  and merged with a stable sort (a tie goes to the lower shard, as the
  reference's ``lax.top_k`` gives), and the counters are summed.

A shard whose block count does not divide by ``sync_every`` sweeps
poison blocks (rows of ``0.5 * BIG ** 0.25``) up to whole rounds, and
they are counted like the pad rows of ``pad_database``, as in the
reference: ``n_candidates`` stays the padded row count.

On a CUDA mesh (``launch.mesh.make_host_mesh``'s default) the group is
NCCL's and the stages launch the kernels on each rank's card.  Gloo takes
CPU tensors, so under gloo the exchanged values travel through host
memory: that is the collective's own copy, the stages stay on the
device.  A collective that fails raises; nothing falls back to the
unsharded scan.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import pipeline as pipe
from repro_torch.core.cascade import (
    BatchSearchResult,
    SearchResult,
    _batch_stats,
    init_carry,
    make_block_step,
)
from repro_torch.core.dtw import BIG, PNorm, finish_cost
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.envelope.ops import envelope_op

__all__ = ["Mesh", "ShardedRows", "pad_database", "shard_database", "sharded_nn_search"]

#: the value of a pad row and of a poison block's rows: never a neighbour
PAD_ROW_VALUE = 0.5 * BIG ** 0.25


class _ShardGroup:
    """The ranks that hold one copy of every shard over some mesh axes:
    the process group over them and each shard's place in it."""

    def __init__(self, group, order: list[int], via_host: bool):
        self.group = group  # None: the default group
        self.order = order  # order[s]: the group rank holding shard s
        self.via_host = via_host

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        return t.to("cpu", copy=True) if self.via_host else t.clone()

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        buf = self._send(t.contiguous())
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's ``t`` joined along ``dim`` in shard order."""
        src = self._send(t.contiguous())
        outs = [torch.empty_like(src) for _ in self.order]
        dist.all_gather(outs, src, group=self.group)
        return torch.cat([outs[g] for g in self.order], dim=dim).to(t.device)


class Mesh:
    """Named axes over the ranks of the default ``torch.distributed``
    process group, one rank a device: what a ``jax.sharding.Mesh`` is to
    the reference.  ``shape[ax]`` is an axis's size by name; rank r sits
    at the row-major coordinate of r over ``axis_names``; ``device`` is
    this rank's device (default: the GPU)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device=None):
        sizes = tuple(int(s) for s in shape)
        names = tuple(str(a) for a in axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names) or min(sizes, default=0) < 1:
            raise ValueError(
                f"a mesh needs one positive size per distinct axis name, got shape "
                f"{sizes} and axes {names}"
            )
        self.device = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError(
                "no torch.distributed process group is initialised: call "
                "init_process_group (one rank per device) or "
                "repro_torch.launch.mesh.make_host_mesh first"
            )
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"mesh shape {sizes} needs {math.prod(sizes)} ranks, "
                             f"the process group has {world}")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.size = world
        self.rank = dist.get_rank()
        self.coords = dict(zip(names, (int(c) for c in np.unravel_index(self.rank, sizes))))
        self.backend = dist.get_backend()
        self._groups: dict[tuple[str, ...], _ShardGroup] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device}, {self.backend})"

    # ------------------------------------------------ the serving transport
    #
    # A ``QueryEngine`` over a multi-rank session admits on rank 0 and sends
    # each batch it routes to the sharded driver to every other rank, which
    # runs the same search: the collectives of ``sharded_nn_search`` then
    # pair the same searches.  The sends and the searches of a rank must
    # come from one thread, so that the default group's collectives stay in
    # one order; while an engine serves such a session no other thread of
    # any rank may run a sharded search.  A failed collective raises.

    def _object_device(self) -> torch.device:
        # gloo takes CPU tensors; NCCL the rank's own device
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def bind_device(self) -> None:
        """Make this rank's device the calling thread's current CUDA device
        (what NCCL's object collectives place their buffers on)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def broadcast_batch(self, obj=None):
        """Rank 0's ``obj`` (a picklable batch, or ``None``) on every rank
        of the mesh; the other ranks' ``obj`` is ignored."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, device=self._object_device())
        return box[0]

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.size
        if self.device.type == "cuda" and self.backend != "gloo":
            with torch.cuda.device(self.device):
                dist.all_gather_object(out, obj)
        else:
            dist.all_gather_object(out, obj)
        return out

    def axes(self, axis_names=None) -> tuple[str, ...]:
        """The sharding axes: ``axis_names``, validated, or every axis."""
        names = tuple(axis_names if axis_names is not None else self.axis_names)
        unknown = [a for a in names if a not in self.shape]
        if unknown or not names or len(set(names)) != len(names):
            raise ValueError(
                f"axis_names {names} must be distinct axes of the mesh {self.axis_names}"
            )
        return names

    def n_shards(self, axis_names) -> int:
        return math.prod(self.shape[a] for a in axis_names)

    def shard_of(self, coords: dict, axis_names) -> int:
        """Row-major shard id of a coordinate over ``axis_names``, in their
        order (the reference's ``axis_index`` sum)."""
        sid = 0
        for ax in axis_names:
            sid = sid * self.shape[ax] + coords[ax]
        return sid

    def shard_id(self, axis_names) -> int:
        return self.shard_of(self.coords, axis_names)

    def shard_group(self, axis_names) -> _ShardGroup:
        """The group of this rank's shards over ``axis_names``: the ranks
        that share its coordinates on every other axis.  The first call
        for a set of axes creates every such group, on every rank alike
        (``new_group`` is collective)."""
        axis_names = self.axes(axis_names)
        if axis_names not in self._groups:
            sizes = tuple(self.shape.values())
            others = [a for a in self.axis_names if a not in axis_names]
            coords = [dict(zip(self.axis_names, (int(c) for c in np.unravel_index(r, sizes))))
                      for r in range(self.size)]
            mine = None
            for key in np.ndindex(*(self.shape[a] for a in others)):
                members = [r for r in range(self.size)
                           if all(coords[r][a] == c for a, c in zip(others, key))]
                group = dist.new_group(members) if others else None
                if self.rank in members:
                    shards = [self.shard_of(coords[r], axis_names) for r in members]
                    mine = (group, [int(g) for g in np.argsort(shards)])
            self._groups[axis_names] = _ShardGroup(*mine, via_host=self.backend == "gloo")
        return self._groups[axis_names]


class ShardedRows(NamedTuple):
    """This rank's shard of a padded database, on its mesh device: what the
    reference's database is once placed with ``NamedSharding``."""

    local: torch.Tensor  # (n_rows // shards, d*n)
    n_rows: int  # rows of the whole padded database
    axis_names: tuple[str, ...]


def shard_database(db, mesh: Mesh, axis_names=None) -> ShardedRows:
    """Copy this rank's rows of ``db`` (all ranks' rows, padded) to its
    device, once."""
    axis_names = mesh.axes(axis_names)
    shards = mesh.n_shards(axis_names)
    n_rows = int(np.shape(db)[0])
    if n_rows % shards:
        raise ValueError(f"db rows ({n_rows}) must divide evenly by the {shards} "
                         f"shards; callers pad with pad_database")
    n_local = n_rows // shards
    lo = mesh.shard_id(axis_names) * n_local
    local = torch.as_tensor(db[lo : lo + n_local], device=mesh.device)
    if local.dtype not in (torch.float32, torch.float64):
        local = local.to(torch.float32)
    return ShardedRows(local.contiguous(), n_rows, axis_names)


def sharded_nn_search(
    q,
    db,
    mesh: Mesh,
    axis_names: Sequence[str] | None = None,
    w: int = 0,
    p: PNorm = 1,
    k: int = 1,
    block: int = 32,
    sync_every: int = 4,
    method: str = "lb_improved",
    d: int = 1,
) -> SearchResult | BatchSearchResult:
    """Search a database sharded over ``mesh`` axes; every rank of the
    mesh calls it alike and gets the same result.

    ``q`` may be a single series (d*n,) -> ``SearchResult`` or a query
    batch (Q, d*n) -> ``BatchSearchResult``; the whole batch rides one
    sharded sweep and one exchanged bound per query.  ``db`` is the
    whole padded database, its rows dividing evenly by (shards * block)
    (callers pad with ``pad_database``), or this rank's shard of it from
    ``shard_database``.
    """
    pipe.check_method(method)
    axis_names = mesh.axes(axis_names)
    rows = db if isinstance(db, ShardedRows) else shard_database(db, mesh, axis_names)
    if rows.axis_names != axis_names:
        raise ValueError(f"db is sharded over {rows.axis_names}, not {axis_names}")
    local = rows.local
    n_local = local.shape[0]
    block = int(block)
    if n_local % block:
        raise ValueError(f"db rows ({rows.n_rows}) must divide evenly by "
                         f"(shards * block); callers pad with pad_database")
    d = int(d)
    if d < 1 or local.shape[1] % d:
        raise ValueError(f"row length {local.shape[1]} not a multiple of d={d}")
    q_t = torch.as_tensor(q, device=local.device).to(local.dtype)
    single = q_t.ndim == 1
    qs = (q_t[None, :] if single else q_t).contiguous()
    nq, n = qs.shape
    k = int(k)
    w = int(min(w, n // d - 1))  # clamped to the per-channel length
    upper, lower = envelope_op(qs, w, d)
    ctx = pipe.make_context(qs, upper, lower, w, p, method, d)
    lb_names = pipe.lb_stage_names(method)
    body = make_block_step(ctx, k, block, method)  # no n_real: every lane counts

    nb = n_local // block
    sync_every = int(sync_every)
    rounds = -(-nb // sync_every)
    lanes = torch.arange(block, device=local.device)
    base = mesh.shard_id(axis_names) * n_local
    # poison blocks fill the last round (top-k ignores them); int64 ids
    poison = local.new_full((block, n), PAD_ROW_VALUE)
    poison_i = torch.full((block,), n_local * 10**6, dtype=torch.int64, device=local.device)
    shards = mesh.shard_group(axis_names)
    carry = init_carry(k, nq, len(lb_names), local.dtype, local.device)
    for r in range(rounds):
        for t in range(r * sync_every, (r + 1) * sync_every):
            if t < nb:
                carry = body(carry, local[t * block : (t + 1) * block], base + t * block + lanes)
            else:
                carry = body(carry, poison, poison_i)
        top_v, top_i, gbound, *counters = carry
        # the paper's "communicate the distance": one value per query lane
        gbound = shards.all_reduce(torch.minimum(gbound, top_v[:, -1]), dist.ReduceOp.MIN)
        carry = (top_v, top_i, gbound, *counters)

    top_v, top_i, _gbound, cs, c3, b2, b3, w_dp, u_dp = carry
    all_v = shards.all_gather(top_v, dim=1)
    all_i = shards.all_gather(top_i, dim=1)
    sel = torch.argsort(all_v, dim=1, stable=True)[:, :k]
    top_v, top_i = torch.gather(all_v, 1, sel), torch.gather(all_i, 1, sel)
    # per-stage and DP counts per query, then the four block counters,
    # summed over the shards in one exchange
    totals = torch.tensor([b2, b3, w_dp, u_dp], dtype=torch.int64, device=cs.device)
    summed = shards.all_reduce(torch.cat([cs.reshape(-1), c3, totals]), dist.ReduceOp.SUM)
    summed = summed.cpu().numpy()
    n_cs = cs.numel()
    b2, b3, w_dp, u_dp = (int(v) for v in summed[n_cs + nq :])
    agg, per_query = _batch_stats(
        rows.n_rows, lb_names, summed[:n_cs].reshape(len(lb_names), nq),
        summed[n_cs : n_cs + nq], b2, b3, blocks_total=rows.n_rows // block,
        dp_lane_work=w_dp, dp_lane_useful=u_dp,
    )
    distances = finish_cost(top_v, p).cpu().numpy()
    indices = top_i.cpu().numpy()
    if single:
        return SearchResult(distances=distances[0], indices=indices[0], stats=per_query[0])
    return BatchSearchResult(distances=distances, indices=indices, stats=agg,
                             per_query=per_query)


def pad_database(db, mesh: Mesh, axis_names=None, block: int = 32):
    """Pad rows so the DB divides by shards*block; returns (db, n_real)."""
    shards = mesh.n_shards(mesh.axes(axis_names))
    db = np.asarray(db)
    n = db.shape[0]
    n_pad = (-n) % (shards * int(block))
    if n_pad:
        filler = np.full((n_pad, db.shape[1]), PAD_ROW_VALUE, db.dtype)
        db = np.concatenate([db, filler], axis=0)
    return db, n
