"""Time repro_torch's default session on one GPU: build, searches, idle share.

Builds the session ``chip_smoke.py`` phase 3 drives (100,000 random walks
of length 1,000 from seed 0, ``SearchConfig()``, host driver), runs
``--searches`` timed searches of the same 16 queries, one more under
``torch.profiler`` for the device's busy time, and prints one JSON line:
the label, build and search seconds, qps, the host's enqueue time per block
of the search's device loop, idle share, pruning counts, kernel
launches of the first search, the profiled search's device time
by kernel (ms and count), and the card's name and power limit.  The busy
time counts device events only (kernels and copies), so a PyTorch op and
the kernel it launched are not counted twice.  Then ``--searches``
searches of the same queries with ``method="lb_webb"`` (the host loop,
one envelope launch per block) are timed, and one more profiled: their
seconds, device time by kernel, and whether they return the default
search's indices; the same for ``method="kim_improved"`` (LB_Kim first:
since K4 took LB_Kim as its entry, the device loop; before, the host
loop), with its launches and pruning counts and whether its distances
are the default search's bits.

``--src`` points at the ``src`` directory of the checkout to time, so two
commits can be compared on one card in one process tree, in turns:

    python tools/time_default_session.py --label change --dump build/change.npz
    python tools/time_default_session.py --src build/parent/src --label parent \
        --against build/change.npz

``--dump`` saves the search's indices and distances; ``--against`` reads
such a file and adds to the JSON line whether this run's indices are the
same and its distances the same bits.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: blocks of the device loop whose host enqueue is timed
ENQUEUE_BLOCKS = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory holding the repro_torch to time")
    ap.add_argument("--label", default="", help="name printed with the result")
    ap.add_argument("--searches", type=int, default=2)
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--length", type=int, default=1000)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--dump", help="save the indices and distances (.npz)")
    ap.add_argument("--against", help="an .npz from --dump to compare the answers with")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_default_session: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.api import Database
    from repro_torch.data.synthetic import random_walks
    from repro_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(0)
    x = random_walks(rng, args.rows, args.length)
    queries = random_walks(rng, args.queries, args.length)
    t0 = time.perf_counter()
    db = Database.build(x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    db.search(queries[:1])  # first use: kernel build and load
    torch.cuda.synchronize()

    searches, launches, res = [], None, None
    for _ in range(args.searches):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = db.search(queries)
        torch.cuda.synchronize()
        searches.append(time.perf_counter() - t0)
        launches = launches or launch_counts()
    # the host's enqueue per block: the search's device loop over the first
    # ENQUEUE_BLOCKS blocks, timed on the host up to its last launch, from
    # an idle device (fewer launches than the launch queue holds); best of 3
    from repro_torch.core.cascade import fused_block_loop
    from repro_torch.kernels.envelope.ops import envelope_op

    cfg = db.config
    qs = torch.as_tensor(db.prepare_queries(queries), device=db.rows_tensor.device)
    qs = qs.to(db.rows_tensor.dtype).contiguous()
    upper, lower = envelope_op(qs, db.w)
    rows = db.rows_tensor[: ENQUEUE_BLOCKS * cfg.block]
    enqueue = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_block_loop(qs, rows, upper, lower, db.w, cfg.p, cfg.k, cfg.block, 16)
        enqueue.append((time.perf_counter() - t0) / ENQUEUE_BLOCKS)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        db.search(queries)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_by_kernel(prof)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    # lb_webb: the host loop, with an envelope launch per block
    webb_s = []
    for _ in range(args.searches):
        t0 = time.perf_counter()
        webb = db.search(queries, method="lb_webb")
        torch.cuda.synchronize()
        webb_s.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        db.search(queries, method="lb_webb")
        torch.cuda.synchronize()
    webb_kernels = device_by_kernel(prof)
    # kim_improved: whichever loop this tree runs it on
    kim_s, kim_launches = [], None
    for _ in range(args.searches):
        reset_launch_counts()
        t0 = time.perf_counter()
        kim = db.search(queries, method="kim_improved")
        torch.cuda.synchronize()
        kim_s.append(time.perf_counter() - t0)
        kim_launches = kim_launches or launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        db.search(queries, method="kim_improved")
        torch.cuda.synchronize()
        kim_wall_ms = (time.perf_counter() - t0) * 1e3
    kim_kernels = device_by_kernel(prof)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    best = min(searches)
    answers = {}
    if args.dump:
        np.savez(args.dump, indices=res.indices, distances=res.distances)
    if args.against:
        with np.load(args.against) as other:
            answers = {
                "same_indices": bool(np.array_equal(res.indices, other["indices"])),
                "same_distance_bits": res.distances.dtype == other["distances"].dtype
                and res.distances.tobytes() == other["distances"].tobytes(),
                "max_abs_distance_diff": float(np.abs(
                    res.distances.astype(np.float64) - other["distances"]).max()),
            }
    print(json.dumps({
        "label": args.label, "card": card, "build_s": build_s, "search_s": searches,
        "qps": args.queries / best, "enqueue_us_per_block": min(enqueue) * 1e6,
        "profiled_wall_ms": wall_ms, "busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else None,
        "pruned": res.stats.pruned_by, "full_dtw": res.stats.full_dtw,
        "launches": launches, "device_ms_by_kernel": by_kernel, **answers,
        "lb_webb": {
            "search_s": webb_s, "busy_ms": sum(ms for ms, _ in webb_kernels.values()),
            "same_indices_as_default": bool(np.array_equal(webb.indices, res.indices)),
            "device_ms_by_kernel": webb_kernels,
        },
        "kim_improved": {
            "search_s": kim_s, "qps": args.queries / min(kim_s),
            "profiled_wall_ms": kim_wall_ms,
            "busy_ms": sum(ms for ms, _ in kim_kernels.values()),
            "pruned": kim.stats.pruned_by, "full_dtw": kim.stats.full_dtw,
            "launches": kim_launches,
            "same_indices_as_default": bool(np.array_equal(kim.indices, res.indices)),
            "same_distance_bits_as_default":
                kim.distances.tobytes() == res.distances.tobytes(),
            "device_ms_by_kernel": kim_kernels,
        },
    }), flush=True)
    return 0


def device_by_kernel(prof) -> dict:
    """{kernel or copy: (device ms, count)} of a profile, largest first."""
    import torch

    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        out[e.key] = (us / 1e3, e.count)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


if __name__ == "__main__":
    sys.exit(main())
