"""Multi-tenant serving launcher: QueryEngine over one Database session
(port of ``repro.launch.serve``).

Replays a mixed workload — exact repeats (answer-cache targets),
near-duplicate retrieval queries, and cold scans — from several
concurrent client threads through the async engine (DESIGN.md §3.8:
admission -> coalesce -> plan -> cache), optionally with a streaming
session running alongside, and reports sustained qps, p50/p99 latency
and the engine counters.  Every answer is verified bit-identical to a
direct ``db.search`` call before the numbers are printed.  The session
runs on the GPU unless ``--device cpu``; ``--index`` builds the stage-0
triangle index into it.

Usage:
  python -m repro_torch.launch.serve --db-size 2048 --length 256 --queries 64 \\
      --clients 4 --max-batch 8 --max-wait-ms 2 --cache 128
  python -m repro_torch.launch.serve --index --p inf --stream-samples 4096
  python -m repro_torch.launch.serve --device cpu --db-size 96 --length 32 --queries 12
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.api import Database, SearchConfig
from repro_torch.data.synthetic import random_walks
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.search import _parse_p
from repro_torch.serve import QueryEngine


def mixed_workload(
    rng: np.random.Generator,
    db_data: np.ndarray,
    n_queries: int,
    *,
    repeat_frac: float = 0.3,
    near_frac: float = 0.4,
    pool: int = 8,
) -> np.ndarray:
    """The serving traffic mix: ``repeat_frac`` exact repeats drawn from
    a small pool (cache/coalesce targets), ``near_frac`` near-duplicates
    of database rows (the paper's retrieval regime), remainder cold
    random walks — shuffled into one replay order."""
    n, length = db_data.shape
    n_rep = int(n_queries * repeat_frac)
    n_near = int(n_queries * near_frac)
    n_cold = n_queries - n_rep - n_near
    pool_q = db_data[rng.integers(0, n, pool)] + rng.normal(
        scale=0.25, size=(pool, length)
    ).astype(db_data.dtype)
    rep = pool_q[rng.integers(0, pool, n_rep)]
    near = db_data[rng.integers(0, n, n_near)] + rng.normal(
        scale=0.25, size=(n_near, length)
    ).astype(db_data.dtype)
    cold = random_walks(rng, max(n_cold, 1), length)[:n_cold]
    work = np.concatenate([rep, near, cold], axis=0)
    return work[rng.permutation(len(work))]


def replay(
    engine: QueryEngine,
    workload: np.ndarray,
    n_clients: int,
    *,
    deadline: float | None = None,
) -> list[tuple[int, float, object]]:
    """Drive the workload through ``n_clients`` tenant threads (each a
    tenant name, open-loop: submit everything, then collect).  Returns
    ``(workload_index, latency_s, answer)`` triples."""
    shards = [list(range(c, len(workload), n_clients)) for c in range(n_clients)]
    out: list[tuple[int, float, object]] = []
    lock = threading.Lock()

    def client(cid: int):
        t_sub = {}
        futures = []
        for qi in shards[cid]:
            t_sub[qi] = time.perf_counter()
            futures.append(
                (qi, engine.submit(workload[qi], tenant=f"client{cid}",
                                   deadline=deadline))
            )
        for qi, fut in futures:
            ans = fut.result()
            with lock:
                out.append((qi, time.perf_counter() - t_sub[qi], ans))

    threads = [
        threading.Thread(target=client, args=(c,)) for c in range(n_clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=2048)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-queue", type=int, default=4096)
    ap.add_argument("--cache", type=int, default=128, help="answer-cache entries")
    ap.add_argument("--w", type=int, default=0, help="0 = n/10")
    ap.add_argument("--p", type=_parse_p, default=1, help="1, 2 or inf")
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--index", action="store_true",
                    help="build the stage-0 triangle index into the session")
    ap.add_argument("--n-refs", type=int, default=8)
    ap.add_argument("--repeat-frac", type=float, default=0.3)
    ap.add_argument("--near-frac", type=float, default=0.4)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request latency budget; 0 = none")
    ap.add_argument("--stream-samples", type=int, default=0,
                    help="also run a streaming session over this many samples")
    ap.add_argument("--stream-threshold", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    data = random_walks(rng, args.db_size, args.length)
    cfg = SearchConfig(w=args.w, p=args.p, k=args.k, block=args.block)
    t0 = time.perf_counter()
    db = Database.build(data, cfg, index=args.index, n_refs=args.n_refs,
                        seed=args.seed, device=device)
    print(f"built session in {time.perf_counter() - t0:.2f}s: {db!r}")

    workload = mixed_workload(
        rng, data, args.queries,
        repeat_frac=args.repeat_frac, near_frac=args.near_frac,
    )
    engine = QueryEngine(
        db,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        cache_capacity=args.cache,
    )
    print(db.plan(args.max_batch).explain())

    # one warmup wave loads the kernels and runs the (max_batch, n) shape
    # once, so the replayed numbers are serving, not start-up
    replay(engine, workload[: args.max_batch], 1)

    deadline = args.deadline_ms / 1e3 if args.deadline_ms > 0 else None
    t0 = time.perf_counter()
    served = replay(engine, workload, args.clients, deadline=deadline)
    wall = time.perf_counter() - t0

    # engine answers must be the direct session answers, bit for bit
    direct = db.search(workload)
    for qi, _, ans in served:
        if not (np.array_equal(ans.distances, direct.distances[qi])
                and np.array_equal(ans.indices, direct.indices[qi])):
            raise SystemExit(
                f"query {qi}: the engine's answer differs from a direct db.search"
            )

    lat_ms = np.sort([1e3 * dt for _, dt, _ in served])
    s = engine.stats()
    print(
        f"replayed {len(served)} queries from {args.clients} clients in "
        f"{wall * 1e3:.1f} ms: {len(served) / wall:.1f} qps sustained"
    )
    print(
        f"latency p50={np.percentile(lat_ms, 50):.2f} ms "
        f"p99={np.percentile(lat_ms, 99):.2f} ms max={lat_ms[-1]:.2f} ms"
    )
    print(
        f"engine: batches={s.batches} occupancy={s.batch_occupancy:.2f} "
        f"coalesced={s.coalesced} cache_hits={s.cache_hits} "
        f"(hit_rate={s.cache_hit_rate:.2f}) expired={s.expired} "
        f"wait_mean={s.wait_ms_mean:.2f} ms"
    )
    print("answers verified bit-identical to direct db.search")

    if args.stream_samples > 0:
        sess = engine.open_stream(threshold=args.stream_threshold)
        signal = random_walks(rng, 1, args.stream_samples)[0]
        t0 = time.perf_counter()
        hits = []
        for lo in range(0, signal.size, 512):
            hits += sess.feed(signal[lo : lo + 512])
        hits += sess.close()
        dt = time.perf_counter() - t0
        print(
            f"stream session: {signal.size} samples in {dt * 1e3:.1f} ms "
            f"({signal.size / dt:.0f} samples/sec), {len(hits)} matches, "
            f"windows={sess.matcher.windows_evaluated}"
        )

    engine.close()


if __name__ == "__main__":
    main()
