"""Distributed DTW search service on the PyTorch port (the twin of
``examples/search_service.py``).

One ``repro_torch.api.Database`` session is built on every rank of a
``("data", "model")`` mesh of shape (2, 4) (artifacts computed once), the
mesh is attached so the planner routes onto the sharded driver, and a
``repro_torch.serve.QueryEngine`` serves two concurrent tenants:
admission queues, round-robin microbatch coalescing (DESIGN.md §3.8,
executing through the §3.4 query-major sweeps), and an answer cache that
serves the repeated query without touching the cascade.  Every answer is
checked bit-identical against the same session's single-device scan.

The reference gets 8 devices from ``XLA_FLAGS``; the port runs one
process a rank.  Run plainly, the script starts ``--ranks`` (default 8)
copies of itself in a gloo group over a ``FileStore`` in a temporary
directory: rank r runs on ``cuda:{r % device_count}`` (on a one-GPU host
every rank shares the card), or on the CPU with ``--device cpu``.  Rank 0
admits and prints; every other rank mirrors its sharded batches.  A rank
that fails stops the others and makes the script exit non-zero.

    PYTHONPATH=src python examples/search_service_torch.py
    PYTHONPATH=src python examples/search_service_torch.py --device cpu
"""

import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import Database, SearchConfig
from repro_torch.data.synthetic import random_walks
from repro_torch.launch.mesh import GROUP_TIMEOUT, make_host_mesh, mesh_axis_sizes
from repro_torch.serve import QueryEngine


def serve(db, queries, local) -> None:
    """Rank 0: two tenants through the engine, every answer checked."""
    engine = QueryEngine(db, max_batch=4, max_wait_ms=2.0, cache_capacity=32)
    try:
        # two tenants submit concurrently; the coalescer drains them
        # round-robin into shared sharded sweeps
        results: dict[int, object] = {}

        def tenant(name: str, idxs: list[int]) -> None:
            futures = [(qi, engine.submit(queries[qi], tenant=name)) for qi in idxs]
            for qi, fut in futures:
                results[qi] = fut.result()

        t0 = time.perf_counter()
        threads = [
            threading.Thread(target=tenant, args=("web", list(range(0, 10, 2)))),
            threading.Thread(target=tenant, args=("batch", list(range(1, 10, 2)))),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0

        for qi in range(len(queries)):
            res = results[qi]
            assert np.array_equal(res.distances, local.distances[qi]), qi
            assert np.array_equal(res.indices, local.indices[qi]), qi
            s = res.stats
            print(
                f"query {qi} [{res.tenant}]: nn=#{res.index} dist={res.distance:.2f} "
                f"dtw_lanes={s.full_dtw:4d} pruned={100 * s.pruning_ratio:.1f}% "
                f"lanes={res.batch_lanes} wait={res.wait_ms:.1f}ms"
            )

        # the repeated query is answered from the cache: zero cascade work
        hit = engine.search(queries[3], tenant="web")
        assert hit.cache_hit and np.array_equal(hit.distances, local.distances[3])

        s = engine.stats()
        print(
            f"served {len(queries)} queries from 2 tenants in {dt * 1e3:.1f} ms "
            f"({len(queries) / dt:.1f} queries/sec): batches={s.batches} "
            f"occupancy={s.batch_occupancy:.2f} cache_hits={s.cache_hits} "
            f"coalesced={s.coalesced}; all answers match the single-device scan.",
            flush=True,
        )
    finally:
        engine.close()  # drains, then stops the other ranks' followers


def run_rank(rank: int, world: int, store: str, device: str) -> None:
    """One rank of the mesh: the session, the mesh and the engine."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    dev = torch.device("cpu") if device == "cpu" else torch.device(
        "cuda", rank % torch.cuda.device_count())
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    try:
        rng = np.random.default_rng(0)
        data = random_walks(rng, 2048, 256)
        queries = random_walks(rng, 10, 256)

        db = Database.build(data, SearchConfig(w=25, block=16), device=dev)
        mesh = make_host_mesh(model_axis=4 if world % 4 == 0 else 1, device=dev)
        db.use_mesh(mesh, sync_every=4)
        if rank == 0:
            print(f"mesh {mesh_axis_sizes(mesh)}, db {db.n_rows} series")
            print(db.plan(queries).explain())
            # reference answers from the same session's single-device scan
            serve(db, queries, db.search(queries, driver="scan"))
        else:
            QueryEngine(db, max_batch=4, max_wait_ms=2.0, cache_capacity=32).close()
    finally:
        dist.destroy_process_group()


def launch(ranks: int, device: str | None) -> int:
    """Start the ranks as subprocesses; the first non-zero exit stops the
    rest and is returned."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        device = "cuda"
    if device != "cpu":
        from repro_torch.kernels import cuda_lib

        cuda_lib.library()  # built once here, loaded by every rank
    with tempfile.TemporaryDirectory(prefix="search_service_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--device", device, "--ranks", str(ranks),
             "--rank", str(r), "--store", store]) for r in range(ranks)]
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [c for c in codes if c not in (None, 0)]
                if bad:
                    return bad[0]
                if all(c == 0 for c in codes):
                    return 0
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the GPU (the default): rank r on cuda:{r %% device_count}")
    ap.add_argument("--ranks", type=int, default=8, help="processes of the mesh")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is None:
        sys.exit(launch(args.ranks, args.device))
    run_rank(args.rank, args.ranks, args.store, args.device)
