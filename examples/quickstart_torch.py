"""Quickstart on the PyTorch port: the paper in 60 seconds, through the
session API (``repro_torch.api``; the twin of ``examples/quickstart.py``).

Builds a ``repro_torch.api.Database`` over a random-walk time-series
database (build-once artifacts: envelopes, powered norms, device upload),
then searches it with the full scan, LB_Keogh (Algorithm 2) and the
paper's two-pass LB_Improved (Algorithm 3), printing pruning power and
speedup — the paper's headline result (Figures 6-10).  Then: the
planner's explanation of the routing, a whole query batch through one
query-major sweep (checked against the direct ``nn_search_host`` call),
and a ``save`` -> ``load`` round trip showing the session serves warm
with zero rebuild.  Runs on the GPU; ``--device cpu`` runs the plain
PyTorch versions of the kernels.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --rows 1100 --length 64
"""

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.api import Database, SearchConfig
from repro_torch.core.cascade import nn_search_host
from repro_torch.data.synthetic import random_walks


def main(n_db: int = 2000, length: int = 512, device=None) -> None:
    rng = np.random.default_rng(0)
    w = length // 10  # the paper's locality constraint

    data = random_walks(rng, n_db, length)
    query = random_walks(rng, 1, length)[0]

    print(f"database: {n_db} random walks x {length} samples, w={w} (DTW_1)\n")
    # one build serves every method: the cached artifacts depend only on
    # (w, p, precision, znorm), so the stage pipeline is a per-call override
    db = Database.build(data, SearchConfig(w=w), device=device)
    results = {}
    for method in ("full", "lb_keogh", "lb_improved"):
        db.search(data[0], driver="host", method=method)  # warm up
        t0 = time.perf_counter()
        res = db.search(query, driver="host", method=method)
        dt = time.perf_counter() - t0
        results[method] = (res, dt)
        s = res.stats
        print(
            f"{method:12s}: nn=#{res.index} dist={res.distance:8.2f} "
            f"{dt*1e3:8.1f} ms | DTW computed for {s.full_dtw:4d}/{s.n_candidates} "
            f"({100*s.pruning_ratio:.1f}% pruned; lb1={s.lb1_pruned}, lb2={s.lb2_pruned})"
        )

    full_t = results["full"][1]
    print(
        f"\nspeedup vs full scan: LB_Keogh {full_t/results['lb_keogh'][1]:.2f}x, "
        f"LB_Improved {full_t/results['lb_improved'][1]:.2f}x"
    )
    assert results["full"][0].index == results["lb_improved"][0].index
    print("all three methods agree on the nearest neighbour (exactness).\n")

    # ---- the planner, explained: why this database takes its driver
    print(db.plan(query).explain(), "\n")

    # ---- query-major batching: one sweep, many queries
    queries = random_walks(rng, 8, length)
    batched = db.search(queries)  # warm up the (Q, n) shapes
    t0 = time.perf_counter()
    batched = db.search(queries)
    bt = time.perf_counter() - t0
    print(
        f"batched: {len(batched)} queries in one sweep, {bt*1e3:.1f} ms "
        f"({len(batched)/bt:.1f} queries/sec)"
    )
    # the facade routes onto the direct entry points bit for bit
    direct = nn_search_host(queries, data, w=w, block=32, method="lb_improved",
                            device=db.device)
    assert np.array_equal(batched.distances, direct.distances)
    assert np.array_equal(batched.indices, direct.indices)
    print("facade results identical to the direct nn_search_host call (exactness).")

    # ---- persist the session, serve warm: build once, query many
    with tempfile.TemporaryDirectory() as td:
        path = db.save(os.path.join(td, "session.npz"))
        size_mb = os.path.getsize(path) / 2**20
        warm = Database.load(path, device=device)
        warm.search(query)  # warm up
        t0 = time.perf_counter()
        r2 = warm.search(query)
        warm_t = time.perf_counter() - t0
    assert r2.index == results["lb_improved"][0].index
    print(
        f"saved bundle {size_mb:.1f} MiB; reloaded session answers in "
        f"{warm_t*1e3:.1f} ms with zero rebuild (envelopes, norms and config "
        f"ride in the bundle)."
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--length", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; 'cpu' runs the plain versions)")
    args = ap.parse_args()
    main(args.rows, args.length, args.device)
