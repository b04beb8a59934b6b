"""DTW search service launcher (port of ``repro.launch.search``).

Serves nearest-neighbour queries through one ``repro_torch.api.Database``
session: artifacts (envelopes, powered norms, optionally the stage-0
triangle index) are built once, the planner picks the pipeline —
sharded over the host mesh by default, the 4-stage indexed cascade with
``--index`` — and the query queue drains through query-major
microbatches, every batch riding one sweep.  The session runs on the GPU
unless ``--device cpu``.

The host mesh (``launch.mesh.make_host_mesh``) spans the ranks of the
default ``torch.distributed`` group, or one rank (NCCL on the GPU, gloo
on the CPU) when the launcher is started alone.  ``--anytime 64,128``
builds the anytime subsequence tier at those lengths; ``--mode anytime``
(with ``--budget``) serves budgeted best-so-far answers with error
bounds through it, and a ``--query-length`` other than the session's
routes through it too.  The anytime route attaches no mesh.

Persistence: ``--db-path x.npz`` saves/loads the whole session bundle
(data + envelopes + index + config, the reference's keys), so a
restarted service skips every build step.  ``--index-path`` keeps the
index-only store.

Usage:
  python -m repro_torch.launch.search --db-size 4096 --length 512 --queries 16 \\
      --query-batch 8
  python -m repro_torch.launch.search --index --p inf --n-refs 16 \\
      --db-path /tmp/rw.session.npz
  python -m repro_torch.launch.search --device cpu --db-size 200 --length 64 \\
      --queries 3 --index --p inf --n-refs 6
  python -m repro_torch.launch.search --device cpu --db-size 200 --length 64 \\
      --queries 3 --anytime 32,64 --mode anytime --query-length 32 --budget 64
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np

from repro_torch.api import Database, SearchConfig
from repro_torch.core.microbatch import drain_queries, iter_query_batches
from repro_torch.data.synthetic import random_walks
from repro_torch.index import load_index, save_index
from repro_torch.index.store import npz_path
from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes

__all__ = ["drain_queries", "iter_query_batches", "main"]


def _parse_p(s: str):
    if s.strip().lower() in ("inf", "infinity"):
        return math.inf
    v = float(s)
    if not np.isfinite(v) or v <= 0:
        raise ValueError(f"p must be a positive norm order or 'inf', got {s!r}")
    return int(v) if v == int(v) else v


def _config(args) -> SearchConfig:
    return SearchConfig(w=args.w, p=args.p, k=args.k, block=args.block, method=args.method)


def load_session(args) -> Database | None:
    """Load the serving session from ``--db-path`` if a bundle exists.

    A loaded bundle *is* the session — its data, config and artifacts
    win over the CLI flags (they are what the artifacts are valid for).
    Every flag the bundle overrides is warned about; ``--k`` stays live
    because it is per-call-safe.
    """
    if not (args.db_path and os.path.exists(npz_path(args.db_path))):
        return None
    db = Database.load(args.db_path, device=args.device)
    print(f"loaded session bundle from {args.db_path}: {db!r}")
    config = _config(args)
    diffs = [
        f"--{f}: bundle={getattr(db.config, f)!r} flag={getattr(config, f)!r}"
        for f in ("w", "p", "block", "method", "znorm", "precision")
        if getattr(db.config, f) != getattr(config, f)
    ]
    if (db.n_rows, db.length) != (args.db_size, args.length):
        diffs.append(
            f"--db-size/--length: bundle holds {db.n_rows} x {db.length}, "
            f"flags describe {args.db_size} x {args.length} — serving the "
            f"bundle's data (queries are generated at its length)"
        )
    if args.index != (db.index is not None):
        diffs.append(
            f"--index: bundle={'has' if db.index else 'has no'} stage-0 "
            f"index, flag asked for {'one' if args.index else 'none'} — "
            f"the planner serves what the bundle has"
        )
    if args.anytime and db.anytime is None:
        diffs.append(
            "--anytime: bundle has no anytime tier — rebuild without "
            "--db-path (or delete the bundle) to add one"
        )
    if diffs:
        print(
            "warning: serving under the bundle's saved session; these "
            "CLI flags are ignored (rebuild without --db-path, or "
            "delete the bundle, to change them):\n  " + "\n  ".join(diffs)
        )
    return db


def build_session(args, db_data: np.ndarray) -> Database:
    """Build (and optionally persist) the serving session from the flags."""
    index: object = False
    if args.index:
        if args.index_path and os.path.exists(npz_path(args.index_path)):
            index = load_index(args.index_path)
            print(f"loaded index from {args.index_path} (R={index.n_refs})")
        else:
            index = True
    anytime: bool | dict = False
    if args.anytime:
        anytime = {"lengths": tuple(int(s) for s in args.anytime.split(","))}
    t0 = time.perf_counter()
    db = Database.build(
        db_data, _config(args), index=index, anytime=anytime, n_refs=args.n_refs,
        n_clusters=args.n_clusters or None, seed=args.seed, device=args.device,
    )
    dt = time.perf_counter() - t0
    print(f"built session in {dt:.2f}s: {db!r}")
    if args.index and index is True and args.index_path:
        print(f"saved index to {save_index(db.index, args.index_path)}")
    if args.db_path:
        print(f"saved session bundle to {db.save(args.db_path)}")
    return db


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=4096)
    ap.add_argument("--length", type=int, default=512)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--query-batch", type=int, default=8,
                    help="queries served per sweep (query-major microbatching)")
    ap.add_argument("--w", type=int, default=0, help="0 = n/10")
    ap.add_argument("--p", type=_parse_p, default=1, help="1, 2 or inf")
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--method", type=str, default="lb_improved",
                    help="stage pipeline (repro_torch.core.pipeline.PIPELINES), or "
                    "'auto' to let the calibrated cascade planner order the bounds")
    ap.add_argument("--sync-every", type=int, default=4,
                    help="blocks between the sharded driver's bound exchanges")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--index", action="store_true",
                    help="serve through the stage-0 triangle index instead of the mesh scan")
    ap.add_argument("--n-refs", type=int, default=16)
    ap.add_argument("--n-clusters", type=int, default=0, help="0 = n_refs")
    ap.add_argument("--db-path", type=str, default="",
                    help="load the whole session bundle (data+envelopes+index+config) "
                    "from this .npz if present, else build and save it")
    ap.add_argument("--index-path", type=str, default="",
                    help="index-only store: load the index from this .npz if "
                    "present, else build and save it")
    ap.add_argument("--anytime", type=str, default="",
                    help="build the anytime subsequence tier at these comma-separated "
                    "lengths (e.g. '64,128'); required for --mode anytime")
    ap.add_argument("--mode", type=str, default="exact", choices=("exact", "anytime"),
                    help="'anytime' serves budgeted best-so-far answers with sound "
                    "error bounds through the cluster tier")
    ap.add_argument("--budget", type=int, default=0,
                    help="anytime exploration budget in refined windows per query "
                    "(0 = unlimited, which bit-matches exact)")
    ap.add_argument("--query-length", type=int, default=0,
                    help="query length (0 = the session's series length); shorter "
                    "lengths route through the anytime subsequence tier")
    ap.add_argument("--device", type=str, default=None,
                    help="device to serve on (default: the GPU; 'cpu' runs the "
                    "plain versions)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    db = load_session(args)
    if db is None:  # no bundle: synthesize and build (the cold path)
        db = build_session(args, random_walks(rng, args.db_size, args.length))
    # queries follow the session's series length, or --query-length,
    # which routes through the anytime subsequence tier
    qlen = args.query_length or db.length
    queries = random_walks(rng, args.queries, qlen)
    budget = args.budget or None
    anytime_route = args.mode == "anytime" or (
        db.anytime is not None and qlen != db.length
    )
    # --queries 0 (config-printout smoke runs) stays a graceful no-op
    batch = max(1, min(args.query_batch, args.queries))
    indexed = db.index is not None
    if not (indexed or anytime_route):
        mesh = make_host_mesh(device=args.device)
        db.use_mesh(mesh, sync_every=args.sync_every)
        print(f"mesh={mesh_axis_sizes(mesh)}")
    print(f"db={db.n_rows} series x {db.length} w={db.w} p={db.p} query_batch={batch}")
    print(db.plan(batch, mode=args.mode, budget=budget, length=qlen).explain())

    def search_block(block_q):
        # k is per-call-safe; mode/budget route per call as well
        return db.search(block_q, k=args.k, mode=args.mode, budget=budget)

    t_all = time.perf_counter()
    for qi, res in enumerate(drain_queries(queries, search_block, batch)):
        s = res.stats
        if anytime_route:
            extra = (
                f"err<={res.error_bound:.3f} refined={s.refined}"
                f"/{s.n_windows} clusters={s.clusters_explored}"
                f"/{s.clusters_total} "
            )
        elif indexed:
            extra = (
                f"stage0={s.lb0_pruned} ({100*s.stage0_ratio:.1f}%) "
                f"clusters={s.clusters_pruned}/{s.clusters_total} "
            )
        else:
            extra = ""
        per_stage = " ".join(f"pruned_{name}={n}" for name, n in s.pruned_by.items())
        print(
            f"query {qi}: nn={res.index} dist={res.distance:.3f} "
            f"{extra}"
            f"{per_stage + ' ' if per_stage else ''}"
            f"dtw={s.full_dtw} ({100*s.pruning_ratio:.1f}% pruned)"
        )
    dt = time.perf_counter() - t_all
    print(
        f"served {args.queries} queries in {dt*1e3:.1f} ms "
        f"({args.queries/dt:.1f} queries/sec at batch {batch})"
    )


if __name__ == "__main__":
    main()
