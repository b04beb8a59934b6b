#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA GPU: build, check, drive.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases (any failure raises, exits non-zero and prints no result line):

1. Toolchain and build: the card, CUDA, nvcc, and the kernels compiled
   from ``src/repro_torch/csrc``.
2. Each CUDA kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge shapes, with its time per call
   (CUDA events around back-to-back calls, the host's launch path
   included), its device time (the kernel's own time under
   torch.profiler), the plain version's time, its lower bound and, where
   one PyTorch call computes the same function, that call's time.  LB_Kim
   (K6) must be bit-equal to its plain version at p in {1, 2, inf},
   float32 and float64, with and without a mask, at B = 1, 37 and 1,024
   rows of n = 37, 1,000 and 1,001, on rows as allocated and on the same
   buffer viewed one value further on (at n = 1,000 no row start is
   16-byte aligned there: the scalar path), at every tile, its feature
   phase alone too, and is timed at
   Q=16, B=32 and B=1,024 beside an empty kernel (the floor of a launch's
   device time).  The DP kernel (K5) must be bit-equal to ``dtw_wavefront_plain`` on every
   lane, finished or abandoned, and is also timed at 5 pairs, at the
   brute force's dense shape and against its dependency-chain bound; its
   masked-dense entry, which ends with the merge (dtw_merge), must be
   bit-equal to the pair-list entry on live slots and write no other
   slot, and bit-equal to ``dtw_masked_plain`` (the kernel's wavefront
   DP) then ``block_merge_plain`` over Q in {1, 16, 33}, k in {1, 5},
   float32 and float64, with ties, an all-dead and a ragged tail block,
   with and without bounds, and at the main path's Q=16, B=32.  The
   envelope kernel (K1) must be bit-equal to its plain version at the
   main path's shapes and at the chunk edges of its scheme, on both of
   its paths (a block per row for small batches, else a warp per row),
   and is timed at the build's 100,000 rows and at the search's 16.  The fused LB kernel (K4, one warp per
   pair) must be bit-equal to LB_Keogh (K2) plus pass 2 (K3) under every
   schedule, at edge shapes and at long rows, with its stage output, and
   its kim entry (LB_Kim first, the kim_improved loop) to K6's plain
   LB_Kim then K2 + K3 on its short and long-row paths, both grids; the
   stream entry (K7) to K2 on the copied windows, its channel entry (K7c,
   a (d, L) segment) to K2 on the gathered (B, d*n) tile at d in {2, 3,
   8}, n in {37, 128, 1,000}, hop in {1, 4}, p in {1, 2, inf}, float32
   and float64, H to its plain version; every schedule of a
   family's tune space to its fallback; the standalone merge kernel
   (block_merge) to its plain version, ties included.  K2 and K3 are also
   timed at Q=16, B=1,024 and at Q=1 (the reference's single-query
   kernels K8a and K8b).  Long rows: every kernel at float32 n = 12,288
   and float64 n = 6,144, w = n // 10 and n - 1 (past the shared-memory
   form of K1, K3, K4 and K5, which take their long-row paths), and K5 at
   n = 32,768, w = 500, each against its plain version, with each long
   path's time per call.
3. The main path: a default ``Database`` session (100,000 random walks
   of length 1,000, ``SearchConfig()``) built and searched with 16 new
   queries through the host driver's device-resident loop: exactly two
   launches per block, K4 and K5 with the merge (dtw_merge), no
   standalone merge, no K2/K3 launch, and the
   loop run again under ``torch.cuda.set_sync_debug_mode("error")`` (no
   synchronisation inside it) with the same answers; the pruning counts
   must be the recorded ones, two queries' top-1 must equal a brute
   force over all rows, and every distance must match the float64
   oracle.  Then a long-row session (2,048 random walks of 12,288,
   float32): built, searched through the same loop (K4 on its long-row
   path), two launches per block, the loop again under sync debug mode,
   top-1 against a K5 brute force; and its first 512 rows on the scan
   route, top-1 against the brute force too.
4. A small session (768 rows of 128) on the scan driver for every
   univariate method, on the GPU and on the CPU: same indices.  Then the
   stream form of LB_Improved (K7, then K3) over a flat segment against
   its plain version.
5. The tuned session: ``Database.build(rows, tune=...)`` on phase 3's
   rows (every family's sweep printed), a save/load round trip that
   re-installs the table, ``method="auto"`` and ``method="kim_improved"``
   searches that must answer as the untuned session does, measured costs
   in ``plan().explain()``, and ``python -m repro_torch.launch.tune``.
   Before it, the untuned session's ``kim_improved`` search: the device
   loop (one launch of K6's feature phase, then per block K4 with its kim
   entry and K5 with the merge, no K6 launch), the loop again under sync
   debug mode, the default session's answers; and its ``kim_webb``
   search, which keeps the host loop (K6 alone once per block, then K2,
   LB_Webb and pair-list DP launches): the default session's answers, and
   LB_Kim and LB_Keogh prune the lanes they pruned in ``kim_improved``'s
   loop.
6. The indexed session on phase 3's rows: ``Database.build(..., index=True,
   n_refs=16)`` at p = inf (Theorem 1's c = 1, where stage 0 prunes) and
   at p = 1 (c = 201), its build split into the session and the index,
   16 queries through the indexed driver (the plan must say so), its
   stage-0 and per-stage counts and its device ms by kernel; two queries'
   top-1 against a K5 brute force at each p, and every answer against an
   unindexed session at the same p on its own route (phase 3's at p = 1,
   the host loop at p = inf): the same indices, the same distance bits.
   Then ``python -m repro_torch.launch.search`` as a subprocess, with
   ``--index --p inf --n-refs 16`` and with its defaults (which serve
   through a one-rank NCCL mesh: the ``mesh={'data': 1, 'model': 1}``
   line and ``driver: sharded``), each query's ``nn`` against a direct
   ``db.search``, and ``python examples/quickstart_torch.py`` at its full
   2,000 x 512.
7. The stream session: ``Database.build`` of four templates of 128
   (``SearchConfig(w=12, p=2, block=64)``) and ``db.stream(hop=4)`` over a
   planted stream of 1,048,576 samples pushed in 4,096-sample chunks and
   polled after each, thresholds calibrated over its first 4,096 samples;
   znorm off (S1 by K7 over each block's flat segment, once a block, no
   dense S1 stage) and on (S1 by K2's dense form, no K7).  Each run's
   matches must equal the offline ``windowed_matches`` and a K5 brute
   force over every window (the same pairs and distance bits; the brute
   force's first chunk against ``dtw_wavefront_plain`` and ``dtw_plain``),
   and env + stages + dtw must equal the windows for each template.  On a
   few of the run's blocks (the first two, the first two whose DP ran and
   the flushed tail) every kernel of the path is held against its plain
   version at the session's shapes: K7 on the block's flat segment (and
   against K2 on the tile and the S1 values the stages used), K2, K3 and
   K5 on the tile and on its S0 survivors' pairs.  Then
   StreamState's online envelope against K1 on rows with subnormals, a
   breakdown of the session's time on a quarter of the stream with one
   profiled run, and ``examples/motion_segmentation_torch.py`` at 6,000
   samples.
8. The serve phase: a ``QueryEngine`` (max_batch 16) over phase 3's
   session serves 64 requests of the serve CLI's mixed workload from 4
   client threads while a stream session (16 rows as templates, hop 16)
   takes 262,144 samples of a random walk in its own thread; every answer
   must equal a direct ``db.search`` of the workload (indices and
   distance bits), the stream's matches a direct ``db.stream`` matcher's,
   and the stream session's kernels on a few of its blocks against their
   plain versions as in phase 7.  Then ``python -m repro_torch.launch.stream`` at its defaults and with
   ``--znorm`` and ``python -m repro_torch.launch.serve --stream-samples
   4096`` as subprocesses, each printing the reference's lines.
9. The multivariate tier: a session of 100,000 random walks of (315, 3)
   (the shape of UWaveGestureLibrary in the UEA multivariate archive, a
   3-axis accelerometer gesture; one walk per channel) under
   ``SearchConfig()``, 16 queries through the host driver's device loop:
   per block K2, the folded K3 (the channels as its rows) and K5's
   masked channel entry with the merge, no K4, the loop again under
   sync debug mode; top-1 of two queries against a brute force by K5's
   channel entry over every row, every top-1 against the float64
   ``dtw_reference_mv``, and the session at ``early_abandon=True`` with
   the same answers.  On the first two blocks and the tail block K1 on
   the (B*d, n) segment view, K2, the folded K3 and K5's channel entry
   (pair list, and masked with the merge) against their plain versions;
   K5's channel entry also at p in {2, inf}, d = 8 and on its in-place
   path.  Then a 768 x (128, 3) session on the scan route for every
   method (``tc_tri`` on an indexed build, R = 8), each giving ``full``'s
   indices, and an (N, n, 1) build of phase 3's rows with phase 3's
   pruning, top-1 rows and distance bits.
10. Multivariate streaming and serving: phase 7's configuration at d = 3
   (``Database.build`` of four (128, 3) templates, ``db.stream(hop=4)``)
   over three random-walk channels of 262,144 rows (44 minutes of a
   3-axis accelerometer at 100 Hz) with 128 plants in all channels at
   the same starts, pushed in 4,096-row chunks and polled; znorm off (S1
   by K7c over each block's (d, span) segment, once a block) and on (S1
   by K2 on the copied tile, no K7c).  Each run's matches and counters
   must equal the offline ``windowed_matches(d=3)``, every plant must be
   found, every match's distance must be K5c's bits on its pair, and the
   offline scan of the first 16,384 rows must equal a K5c brute force
   over every window there; K7c on a few of the session's segments
   against its plain version, K2 on the tile and the stages' S1.  Then a
   ``QueryEngine`` (max_batch 16) over phase 9's session serves 32 (315,
   3) requests from 4 threads (every answer a direct ``db.search``'s
   bits), and a second engine's ``open_stream`` over a 16-row (128, 3)
   session gives a direct ``db.stream``'s matches and counters, with
   ``stream_samples`` counting rows x 3.
11. The sharded driver (after phase 10, its own session): phase 3's rows
   and queries through ``make_host_mesh()`` (one NCCL rank) and
   ``Database.use_mesh(mesh, sync_every=4)``; the plan must say
   ``sharded``, the answers must be ``nn_search_scan``'s indices and
   distance bits on the same rows and every counter its own but LB_Keogh's,
   which counts the pad and poison lanes more (3 poison blocks of 32 a
   query), with no K4 and no K5m launch.  Then two gloo ranks on the one
   card (subprocesses; NCCL takes one rank a device), each making phase
   3's rows and sweeping half: both ranks' results equal, the one-rank
   run's indices and distance bits, the counters closing over the lanes
   swept.  K2 (dense and on the pairs past LB_Keogh), K3 and K5 (on the
   DP pairs, the block's bound as each lane's) against their plain
   versions on five captured blocks of the sweep, the last a poison block.
12. The anytime tier's build side (after phase 11): phase 3's rows built
   with ``anytime=True``, the whole-row tier (100,000 windows, its bank
   the session's rows tensor, 32 coarse clusters) whose radii are two
   K5 sweeps of the representatives against every window (w = 100 and
   the wide band 200, 49 launches of 32 x 2,048 pairs each); the build's
   seconds split into the session, the tier's host work and the sweeps
   (wall and device stream); K5 bit-equal to ``dtw_wavefront_plain`` on
   the first and last chunk of every sweep; the tree's invariants (the
   windows partitioned, sampled boxes holding their members and nesting,
   sampled radii equal to K5's extreme over their members and bounding
   ``dtw_reference`` within rtol 2e-4); ``from_arrays(to_arrays())``
   keeping every tier array's bits; the exact search on the anytime
   session giving phase 3's indices and distance bits.  Then the first
   10,000 rows at lengths (256, 1,000) (hop 64: 120,000 windows of 256)
   with the same checks, and a 2,000-row session of that configuration
   through ``save``/``load``.
13. The anytime tier's search side (after phase 12, on its two
   sessions): two of phase 3's queries with ``mode="anytime"`` and no
   budget on the whole-row tier (the plan must say ``anytime``): phase
   3's indices and distance bits, every error bound 0, and no K4 or K5m
   launch; one of them at budgets of 32, 1,024 and 8,192 windows, each
   answer's error bound sound against phase 3's (``0 <= d - t <= err``)
   and the distances never rising with the budget; then the same two
   queries cut to 256 samples on the 10,000-row session's 256 tier
   (120,000 windows, w = 25; the plan must say ``subsequence``): the
   exact route and unlimited anytime equal to a K5 brute force over the
   whole bank in ``(distance, gid)`` order, bit for bit, and a budget of
   2,048 sound against it.  K1 bit-equal on the query envelopes, and K2,
   K3 and K5 against their plain versions on blocks the refinement ran
   (``captured_scan_blocks``, ``check_scan_blocks``).  Each search prints
   its windows refined, clusters explored, DPs, residual bound and
   seconds a query.
14. Anytime serving (after phase 13, on phase 12's sessions): a
   ``QueryEngine`` over the whole-row tier serves phase 3's two queries
   with ``mode="anytime"`` and no budget (phase 3's indices and distance
   bits, bounds 0), one at a budget of 1,024 and one at 8,192 (each
   bit-equal to a direct ``db.search(q, mode="anytime", budget=)``,
   bounds included), the second again (a cache hit with the same
   bounds), one with a deadline once the refine-rate EMA is seeded (its
   budget ``max(1, int(rate * deadline))``), then anytime and exact
   requests of the same queries interleaved from two tenants (each equal
   to the direct search of its mode, in batches of its own mode); the
   engine's ``EngineStats`` must be the sums over the answers.  An engine
   over the 10,000-row session's 256 tier gives phase 13's bits, unlimited
   and at a budget of 2,048.  K2, K3 and K5 against their plain versions
   on blocks the engine's worker ran.  Then ``python -m
   repro_torch.launch.search`` with ``--anytime 128,512 --mode anytime
   --query-length 128`` on 2,048 x 512, with no budget and with
   ``--budget 256`` (each query's ``nn`` and windows refined equal to a
   direct search of the same rows, no mesh), and
   ``examples/classify_timeseries_torch.py`` (its p in {1, 2, inf}
   accuracies equal to a direct ``db.classify`` on the card), as
   subprocesses run side by side.  Seconds a request at each budget,
   the engine's time beside the direct call's and the EMA in windows/s
   are printed with the card's name and power limit.
15. Sharded serving (after phase 14): two gloo ranks on the one card
   (subprocesses) each build phase 3's session, attach a (2,) ``("data",)``
   mesh with ``sync_every=4``, run one sharded search (its one-off costs)
   and make ``QueryEngine(max_batch=8, start=False)``, while
   ``examples/search_service_torch.py`` runs at its defaults beside them
   (8 gloo ranks on the card; it must end with its check line).  When
   the twin has ended, rank 0 stages phase 3's 16 queries from two tenants,
   then sends a repeated query (a cache hit) and a ``k=2`` request, while
   rank 1's follower runs every batch rank 0 routes to the sharded
   driver.  The answers must be phase 11's one-rank indices and distance
   bits (top-1 phase 3's) and a direct sharded search's of the same
   batches on both ranks; rank 1 must have mirrored the 3 sharded batches
   and not the cache hit; each rank must launch K1, K2, K3 and K5 and no
   K4 or K5m; K2, K3 and K5 against their plain versions on two blocks of
   rank 1's first mirrored search.  Seconds a request and the engine's
   time over a warm direct sharded search are printed.

Launches are counted per phase (3 build, 3 search, the long-row
session's build and search on both routes, 4 scan, 4 stream, 5 tuned,
6 index build and indexed search, each summed over both p, 7 stream
session, stream offline and stream example, 8 serve, 9 mv build, mv
search, mv scan and mv d=1, 10 mv stream session, mv stream offline and
mv serve, 11 sharded, 12 anytime build, anytime search and anytime sub
build, 13 anytime mode and anytime sub search, 14 "14: anytime serving"
(no K4 or K5m), "14: mixed serving" and "14: classify", 15 "15: sharded
serving" (both ranks' counts summed)),
each from zero, and the untuned ``kim_improved`` and ``kim_webb``
searches; phase 2's
comparisons are not counted.  The ``[time]`` lines give seconds by
phase, by sub-step (phases 2 and 6 are split) with the seconds of the
timing calls in each, and the timing call sites that took 2 s or more.
The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  The standalone merge
kernel is on no path (its routine runs as dtw_merge's epilogue): its
entry in the kernels record says so and shows 0 launches.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores; the kernels do scalar float32 work.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_ROWS, LENGTH, N_QUERIES = 100_000, 1000, 16
BLOCK, DTW_CHUNK = 32, 16
SEED = 0
#: candidates of K2's and K3's second timed shape (Q=16, B=1,024)
WIDE_B = 1024
#: the long-row checks: (n, dtype), each at w = n // 10 and w = n - 1
LONG_SHAPES = ((12_288, "float32"), (6_144, "float64"))
#: K5 past its register path's two staged rows: (n, w), float32, 2 pairs
DTW_LONG = (32_768, 500)
#: the long-row session: rows, length (float32, w = n // 10), queries; and
#: the rows of its scan-route twin
LONG_SESSION = (2048, 12_288, 4)
LONG_SCAN_ROWS = 512

#: the default session's pruning counts and top-1 rows as first measured
#: on the card with separate LB_Keogh and LB_Improved launches (PERF.md);
#: the fused route must reproduce them exactly
MAIN_PRUNED = {"lb_keogh": 1_543_800, "lb_improved": 40_029}
MAIN_FULL_DTW = 16_171
MAIN_TOP1 = [43381, 21115]

TOL = {"envelope": 0.0, "lb_keogh": 1e-4, "lb_improved_pass2": 2e-4, "dtw": 3e-4,
       "lb_kim": 0.0, "lb_kim_features": 0.0, "lb_keogh_stream": 1e-4, "lb_fused": 2e-4,
       "block_merge": 0.0, "dtw_merge": 0.0, "dtw_mv": 0.0, "dtw_merge_mv": 0.0,
       "lb_keogh_stream_mv": 1e-4}
SOURCES = {
    "envelope": ("src/repro_torch/csrc/envelope.cu",
                 "src/repro/kernels/envelope/kernel.py:52"),
    "lb_keogh": ("src/repro_torch/csrc/lb_keogh.cu",
                 "src/repro/kernels/lb_keogh/kernel.py:179"),
    "lb_improved_pass2": ("src/repro_torch/csrc/lb_improved.cu",
                          "src/repro/kernels/lb_improved/kernel.py:115"),
    "dtw": ("src/repro_torch/csrc/dtw.cu", "src/repro/kernels/dtw/kernel.py:119"),
    "lb_fused": ("src/repro_torch/csrc/lb_fused.cu",
                 "src/repro/kernels/lb_fused/kernel.py:219"),
    "lb_kim": ("src/repro_torch/csrc/lb_kim.cu", "src/repro/kernels/lb_kim/kernel.py:65"),
    # K6's feature phase alone (repro_lb_kim_features): the query features of
    # K4's kim entry on the kim_improved loop
    "lb_kim_features": ("src/repro_torch/csrc/lb_kim.cu",
                        "src/repro/kernels/lb_kim/kernel.py:65"),
    "lb_keogh_stream": ("src/repro_torch/csrc/lb_keogh.cu",
                        "src/repro/kernels/lb_keogh/kernel.py:127"),
    # no TPU kernel: it stands for the reference's host merge
    "block_merge": ("src/repro_torch/csrc/block_merge.cu", "src/repro/core/cascade.py:555"),
    # K5's masked entry with the merge (csrc/block_merge.cuh) as its epilogue
    "dtw_merge": ("src/repro_torch/csrc/dtw.cu", "src/repro/kernels/dtw/kernel.py:119"),
    # K5's channel entry (multivariate rows, d > 1): pair list, and masked
    # with the merge
    "dtw_mv": ("src/repro_torch/csrc/dtw.cu", "src/repro/kernels/dtw/kernel.py:119"),
    "dtw_merge_mv": ("src/repro_torch/csrc/dtw.cu", "src/repro/kernels/dtw/kernel.py:119"),
    # K7's channel entry (a d-channel stream segment (d, L), d > 1)
    "lb_keogh_stream_mv": ("src/repro_torch/csrc/lb_keogh.cu",
                           "src/repro/kernels/lb_keogh/kernel.py:127"),
}
#: kernels on no path of this script, and why
OFF_PATH = {"block_merge": "its routine (csrc/block_merge.cuh) runs as the epilogue of "
                           "dtw_merge on the host driver's loop; standalone only as the "
                           "routine's yardstick and check"}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


#: seconds by sub-step (``lap``), the seconds of timing calls within each,
#: and the seconds and calls of each timing call site: what the [time]
#: lines report, so that a cut of repetitions can be sized on the card
SUB_STEPS: dict[str, float] = {}
TIMING_IN: dict[str, float] = {}
TIMING_SITES: dict[tuple[str, int], list] = {}
_LAP: list = [None, 0.0]  # the open sub-step and its start


def lap(name: str | None = None) -> None:
    """Close the open sub-step, its seconds to ``SUB_STEPS`` (after the
    card's queue drains), and open ``name``; ``lap()`` only closes."""
    import torch

    torch.cuda.synchronize()
    now = time.perf_counter()
    if _LAP[0] is not None:
        SUB_STEPS[_LAP[0]] = SUB_STEPS.get(_LAP[0], 0.0) + now - _LAP[1]
    _LAP[:] = [name, now]


def _timing_call(t0: float, ms: float) -> None:
    """Book a timing call's seconds to the open sub-step and to the line of
    the script that made it."""
    secs = time.perf_counter() - t0
    TIMING_IN[_LAP[0]] = TIMING_IN.get(_LAP[0], 0.0) + secs
    site = TIMING_SITES.setdefault((_LAP[0], sys._getframe(2).f_lineno), [0.0, 0, ms])
    site[0] += secs
    site[1] += 1


def time_line() -> str:
    """The sub-steps with their timing calls' seconds, and the call sites
    that took 2 s or more."""
    steps = "; ".join(f"{k} {v:.1f} (timing {TIMING_IN.get(k, 0.0):.1f})"
                      for k, v in SUB_STEPS.items())
    sites = sorted(TIMING_SITES.items(), key=lambda kv: -kv[1][0])
    top = "; ".join(f"{step} line {line}: {secs:.1f} s in {n} call(s), {ms:.3f} ms a call"
                    for (step, line), (secs, n, ms) in sites if secs >= 2.0)
    return f"[time] sub-steps: {steps}\n[time] timing call sites of 2 s or more: {top}"


#: a call at least this long (s) is timed one call at a time, three times:
#: more back-to-back calls do not steady its median
SLOW_CALL_S = 0.1


def time_ms(fn, iters: int = 20, repeats: int = 5, warmup: int = 2) -> float:
    """Per-call time: CUDA events around ``iters`` back-to-back calls,
    the median over ``repeats`` such runs.  Where the host cannot enqueue
    as fast as the card runs, this includes the host's launch cost.  A
    call whose last warm-up call took ``SLOW_CALL_S`` or more is timed
    with ``iters`` 1 and at most 3 ``repeats``."""
    import torch

    t0 = time.perf_counter()
    for _ in range(max(warmup, 1)):
        t_call = time.perf_counter()
        fn()
        torch.cuda.synchronize()
    if time.perf_counter() - t_call >= SLOW_CALL_S:
        iters, repeats = 1, min(repeats, 3)
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    ms = statistics.median(runs)
    _timing_call(t0, ms)
    return ms


def kernel_self_us(prof) -> dict[str, tuple[float, int]]:
    """Device self time (us) and count of each CUDA kernel or copy in a
    torch.profiler run, by name."""
    import torch

    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        out[e.key] = (us, e.count)
    return out


PROFILER_ATTEMPTS = 3
# measurements the profiler saw no device events for, timed with events
PROFILER_MISSES: list[str] = []


def profiled_kernels(run, what: str) -> dict[str, tuple[float, int]]:
    """``kernel_self_us`` of ``run()`` under torch.profiler.  A profiler
    session now and then returns no device events at all, so a session
    that saw none is run again, up to ``PROFILER_ATTEMPTS`` sessions; {}
    if none of them saw any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        got = kernel_self_us(prof)
        if sum(us for us, _ in got.values()) > 0:
            return got
        log(f"[profiler] session {attempt + 1} of {PROFILER_ATTEMPTS} saw no device "
            f"time ({what})")
    return {}


def events_device_ms(fn, iters: int = 20, repeats: int = 3) -> float:
    """Device time of one call from CUDA events, for when the profiler
    sees none: two events around ``iters`` calls, all queued behind a
    spinning kernel so the card never waits for the host's launches;
    the median over ``repeats`` of the interval over ``iters`` (the gaps
    between the card's kernels in it)."""
    import torch

    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def device_ms(fn, iters: int = 20, warmup: int = 2, what: str = "") -> float:
    """Device time of one call: the self time of the kernels that
    ``iters`` calls ran under torch.profiler, over ``iters``; the host's
    launch path is not in it.  Where no profiler session saw a kernel,
    the time comes from CUDA events (``events_device_ms``) and the
    measurement is listed in ``PROFILER_MISSES``."""
    import torch

    t0 = time.perf_counter()
    code = getattr(fn, "__code__", None)
    what = what or (f"{getattr(fn, '__qualname__', 'call')} at chip_smoke.py:"
                    f"{code.co_firstlineno if code else '?'}")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    got = profiled_kernels(run, what)
    if got:
        ms = sum(us for us, _ in got.values()) / 1e3 / iters
    else:
        PROFILER_MISSES.append(what)
        ms = events_device_ms(fn, iters)
        log(f"[profiler] {what}: timed with CUDA events instead, {ms:.5f} ms a call")
    _timing_call(t0, ms)
    return ms


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> float:
    den = want.abs().clamp(min=1e-30)
    return float(((got - want).abs() / den).max()) if want.numel() else 0.0


def check_close(name, got, want, rtol, what):
    import torch

    if rtol == 0.0:
        if not torch.equal(got, want):
            fail(f"{name} {what}: not bit-equal to the plain version")
        return 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=0.0):
        fail(f"{name} {what}: max rel err {rel_err(got, want):.3g} > {rtol}")
    return float((got - want).abs().max())


def check_equal(name, got, want, what):
    """Bit-equality of one output or a tuple of outputs."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{name} {what}: not bit-equal")


def counted(launches: dict, phase: str, fn):
    """Run ``fn`` with every kernel's launch count set to 0 first; add the
    counts it leaves to ``launches[phase]``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    before = launches.get(phase, {})
    launches[phase] = {k: before.get(k, 0) + v for k, v in launch_counts().items()}
    reset_launch_counts()
    return out


def require_launched(launches: dict, phase: str, names, what: str):
    for name in names:
        if launches[phase][name] <= 0:
            fail(f"{what}: kernel {name} was not launched ({launches[phase]})")


# ------------------------------------------------------------- phase 1


def phase_toolchain():
    import torch

    from repro_torch.kernels import cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = cuda_lib.find_nvcc()
    nvcc_ver = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"[toolchain] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvcc: {nvcc_ver}")
    t0 = time.perf_counter()
    lib_path, build_log = cuda_lib.build()
    build_s = time.perf_counter() - t0
    cuda_lib.library()
    log(f"[build] {lib_path.relative_to(ROOT)} in {build_s:.1f} s from "
        f"{len(list(cuda_lib.CSRC.glob('*.cu')))} sources")
    # one line per kernel: its name, registers and spills (ptxas -v)
    entry = spills = ""
    for line in build_log.splitlines():
        if line.startswith("=="):
            log(f"[build]   {line.strip()}")
        elif "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            log(f"[build]   {entry}: {regs}; {spills}")
    return smi


# ------------------------------------------------------------- phase 2


def phase_kernels(dev):
    """Every kernel against its plain version; returns the kernels record."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import random_walks
    from repro_torch.kernels.common import BIG
    from repro_torch.kernels.dtw.ops import dtw_launch, dtw_plain, dtw_wavefront_plain
    from repro_torch.kernels.envelope.ops import SMALL_ROWS, envelope_launch, envelope_plain
    from repro_torch.kernels.lb_improved.ops import (
        lb_improved_pass2_launch,
        lb_improved_pass2_plain,
    )
    from repro_torch.kernels.lb_keogh.ops import lb_keogh_launch, lb_keogh_plain

    rng = np.random.default_rng(SEED + 1)
    w = LENGTH // 10

    def walks(count, n, dtype=torch.float32):
        return torch.as_tensor(random_walks(rng, count, n), device=dev).to(dtype)

    rec = {}

    # K1 envelope: bit-equal; timed at the build's shape
    lap("2 K1")
    xs = walks(N_ROWS, LENGTH)
    u, l = envelope_launch(xs, w)
    up, lp = envelope_plain(xs, w)
    check_close("envelope", u, up, 0.0, "U main")
    check_close("envelope", l, lp, 0.0, "L main")
    # edges: one row, the search's 16 queries, n not a multiple of 4 and a
    # batch whose base is not 16-byte aligned, w from 1 to n - 1, the
    # chunk cut to 2w - 1 or about (n + 2w) / 32 (envelope_chunk), n + 2w a
    # multiple of 32 and not, float64 rows too long for two row buffers;
    # each as given (up to SMALL_ROWS rows: a block per row) and with
    # SMALL_ROWS more rows (a warp per row)
    edges = 0
    for dt in (torch.float32, torch.float64):
        for rows, n, ww in [(1, LENGTH, w), (N_QUERIES, LENGTH, w), (7, 97, 5), (5, 64, 63),
                            (3, 2, 1), (9, 300, 40), (4, 1001, 1), (3, 999, 998),
                            (3, LENGTH, 12), (3, LENGTH, 16), (3, LENGTH, 17),
                            (2, 8000, 800)]:
            for r in (rows, SMALL_ROWS + rows):
                x = walks(r + 1, n, dt)
                for label, xv in (("", x[:r]), (" offset", x[1:])):
                    a, b = envelope_launch(xv, ww)
                    c, d = envelope_plain(xv, ww)
                    what = f"{r}x{n} w={ww} {dt}{label}"
                    check_close("envelope", a, c, 0.0, f"U {what}")
                    check_close("envelope", b, d, 0.0, f"L {what}")
                    edges += 1
    ms = time_ms(lambda: envelope_launch(xs, w))
    dms = device_ms(lambda: envelope_launch(xs, w), iters=5)
    q16 = xs[:N_QUERIES].contiguous()
    dms16 = device_ms(lambda: envelope_launch(q16, w))
    plain = time_ms(lambda: envelope_plain(xs, w), iters=2, repeats=3)
    lib = time_ms(lambda: torch.nn.functional.max_pool1d(
        xs[:, None, :], 2 * w + 1, stride=1, padding=w), iters=3, repeats=3)
    bnd, by = bound_ms(3 * xs.numel() * 4, 6 * xs.numel())
    rec["envelope"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd,
                           bound_by=by, library_ms=lib, device_ms=dms,
                           device_ms_16_rows=dms16,
                           shape=f"rows={N_ROWS} n={LENGTH} w={w}")
    del xs, q16, u, l, up, lp
    log(f"[kernel] envelope ok (bit-equal at the main shape and {edges} edge shapes): "
        f"{ms:.4f} ms per call, {dms:.4f} ms on the device ({dms16:.4f} at "
        f"{N_QUERIES} rows) vs plain {plain:.3f} ms, max_pool1d {lib:.4f} ms, "
        f"bound {bnd:.4f} ms ({by})")

    # K2 LB_Keogh + H: lb rtol 1e-4, H bit-equal
    lap("2 K2")
    qs = walks(N_QUERIES, LENGTH)
    cands = walks(BLOCK, LENGTH)
    upper, lower = envelope_launch(qs, w)
    err = 0.0
    for p in (1, 2, math.inf):
        lb, h = lb_keogh_launch(cands, upper, lower, p)
        lbp, hp = lb_keogh_plain(cands, upper, lower, p)
        e = check_close("lb_keogh", lb, lbp, TOL["lb_keogh"], f"lb p={p}")
        err = e if p == 1 else err
        check_close("lb_keogh", h, hp, 0.0, f"H p={p}")
        qi = torch.as_tensor(rng.integers(0, N_QUERIES, 37), device=dev)
        ci = torch.as_tensor(rng.integers(0, BLOCK, 37), device=dev)
        lb, h = lb_keogh_launch(cands, upper, lower, p, qi, ci)
        lbp, hp = lb_keogh_plain(cands, upper, lower, p, qi, ci)
        check_close("lb_keogh", lb, lbp, TOL["lb_keogh"], f"pairs lb p={p}")
        check_close("lb_keogh", h, hp, 0.0, f"pairs H p={p}")
    c7 = walks(7, 50, torch.float64)
    q3 = walks(3, 50, torch.float64)
    u3, l3 = envelope_plain(q3, 4)
    lb, h = lb_keogh_launch(c7, u3.contiguous(), l3.contiguous(), 2)
    lbp, hp = lb_keogh_plain(c7, u3, l3, 2)
    check_close("lb_keogh", lb, lbp, TOL["lb_keogh"], "float64 ragged")
    check_close("lb_keogh", h, hp, 0.0, "float64 ragged H")
    ms = time_ms(lambda: lb_keogh_launch(cands, upper, lower, 1))
    dms = device_ms(lambda: lb_keogh_launch(cands, upper, lower, 1))
    plain = time_ms(lambda: lb_keogh_plain(cands, upper, lower, 1), iters=10)
    nq, b, n = N_QUERIES, BLOCK, LENGTH
    bnd, by = bound_ms(4 * (b * n + 2 * nq * n + nq * b + nq * b * n), 8 * nq * b * n)
    # the same at Q=16, B=1,024: 65.5 MB of H, bound by its writes
    wide = walks(WIDE_B, LENGTH)
    lbw, hw = lb_keogh_launch(wide, upper, lower, 1)
    lbp, hp = lb_keogh_plain(wide, upper, lower, 1)
    check_close("lb_keogh", lbw, lbp, TOL["lb_keogh"], f"B={WIDE_B} lb")
    check_close("lb_keogh", hw, hp, 0.0, f"B={WIDE_B} H")
    del lbp, hp
    ms_w = time_ms(lambda: lb_keogh_launch(wide, upper, lower, 1))
    dms_w = device_ms(lambda: lb_keogh_launch(wide, upper, lower, 1))
    bnd_w, _ = bound_ms(4 * (WIDE_B * n + 2 * nq * n + nq * WIDE_B + nq * WIDE_B * n),
                        8 * nq * WIDE_B * n)
    rec["lb_keogh"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                           bound_by=by, library_ms=None, device_ms=dms,
                           shape=f"Q={nq} B={b} n={n} p=1", ms_B1024=ms_w,
                           device_ms_B1024=dms_w, bound_ms_B1024=bnd_w)
    log(f"[kernel] lb_keogh ok: {ms:.4f} ms per call, {dms:.5f} ms on the device vs "
        f"plain {plain:.3f} ms, bound {bnd:.5f} ms ({by}); at B={WIDE_B}: {ms_w:.4f} ms "
        f"per call, {dms_w:.4f} ms on the device, bound {bnd_w:.4f} ms "
        f"({bnd_w / dms_w:.0%} of it)")

    # K3 LB_Improved pass 2: rtol 2e-4
    lap("2 K3 and K8")
    err = 0.0
    for p in (1, 2, math.inf):
        _, h = lb_keogh_launch(cands, upper, lower, p)
        got = lb_improved_pass2_launch(h, qs, w, p)
        want = lb_improved_pass2_plain(h, qs, w, p)
        e = check_close("lb_improved_pass2", got, want, TOL["lb_improved_pass2"], f"p={p}")
        err = e if p == 1 else err
        hp = h.reshape(-1, LENGTH)[:41].contiguous()
        qi = torch.as_tensor(rng.integers(0, N_QUERIES, 41), device=dev)
        got = lb_improved_pass2_launch(hp, qs, w, p, qi)
        want = lb_improved_pass2_plain(hp, qs, w, p, qi)
        check_close("lb_improved_pass2", got, want, TOL["lb_improved_pass2"],
                    f"pairs p={p}")
    for ww in (0, 500, 5000):
        got = lb_improved_pass2_launch(h, qs, ww, 2)
        want = lb_improved_pass2_plain(h, qs, ww, 2)
        check_close("lb_improved_pass2", got, want, TOL["lb_improved_pass2"], f"w={ww}")
    h64 = walks(3 * 5, 80, torch.float64).reshape(3, 5, 80)
    q64 = walks(3, 80, torch.float64)
    got = lb_improved_pass2_launch(h64, q64, 8, 1)
    want = lb_improved_pass2_plain(h64, q64, 8, 1)
    check_close("lb_improved_pass2", got, want, TOL["lb_improved_pass2"], "float64")
    _, h = lb_keogh_launch(cands, upper, lower, 1)
    ms = time_ms(lambda: lb_improved_pass2_launch(h, qs, w, 1))
    dms = device_ms(lambda: lb_improved_pass2_launch(h, qs, w, 1))
    plain = time_ms(lambda: lb_improved_pass2_plain(h, qs, w, 1), iters=10)
    bnd, by = bound_ms(4 * (nq * b * n + nq * n + nq * b), 11 * nq * b * n)
    # the same at Q=16, B=1,024, on K2's H above
    for p in (1, 2, math.inf):
        hp = hw if p == 1 else lb_keogh_launch(wide, upper, lower, p)[1]
        check_close("lb_improved_pass2", lb_improved_pass2_launch(hp, qs, w, p),
                    lb_improved_pass2_plain(hp, qs, w, p), TOL["lb_improved_pass2"],
                    f"B={WIDE_B} p={p}")
    del hp
    ms_w = time_ms(lambda: lb_improved_pass2_launch(hw, qs, w, 1))
    dms_w = device_ms(lambda: lb_improved_pass2_launch(hw, qs, w, 1))
    bnd_w, _ = bound_ms(4 * (nq * WIDE_B * n + nq * n + nq * WIDE_B), 11 * nq * WIDE_B * n)
    del wide, lbw, hw
    # K8a and K8b, the reference's single-query kernels: K2 and K3 at Q=1
    q1, u1, l1 = (t[:1].contiguous() for t in (qs, upper, lower))
    _, h1 = lb_keogh_launch(cands, u1, l1, 1)
    q1_rec = dict(
        lb_keogh=(time_ms(lambda: lb_keogh_launch(cands, u1, l1, 1)),
                  device_ms(lambda: lb_keogh_launch(cands, u1, l1, 1)),
                  bound_ms(4 * (b * n + 2 * n + b + b * n), 8 * b * n)[0]),
        lb_improved_pass2=(time_ms(lambda: lb_improved_pass2_launch(h1, q1, w, 1)),
                           device_ms(lambda: lb_improved_pass2_launch(h1, q1, w, 1)),
                           bound_ms(4 * (b * n + n + b), 11 * b * n)[0]))
    rec["lb_keogh"].update(ms_Q1=q1_rec["lb_keogh"][0], device_ms_Q1=q1_rec["lb_keogh"][1],
                           bound_ms_Q1=q1_rec["lb_keogh"][2])
    log(f"[kernel] K8a = lb_keogh at Q=1, B={b}: {q1_rec['lb_keogh'][0]:.4f} ms per call, "
        f"{q1_rec['lb_keogh'][1]:.5f} ms on the device, bound {q1_rec['lb_keogh'][2]:.6f} ms; "
        f"K8b = lb_improved_pass2 at Q=1: {q1_rec['lb_improved_pass2'][0]:.4f} ms per call, "
        f"{q1_rec['lb_improved_pass2'][1]:.5f} ms on the device, bound "
        f"{q1_rec['lb_improved_pass2'][2]:.6f} ms")
    rec["lb_improved_pass2"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                    bound_ms=bnd, bound_by=by, library_ms=None,
                                    device_ms=dms, shape=f"Q={nq} B={b} n={n} w={w} p=1",
                                    ms_B1024=ms_w, device_ms_B1024=dms_w,
                                    bound_ms_B1024=bnd_w,
                                    ms_Q1=q1_rec["lb_improved_pass2"][0],
                                    device_ms_Q1=q1_rec["lb_improved_pass2"][1],
                                    bound_ms_Q1=q1_rec["lb_improved_pass2"][2])
    log(f"[kernel] lb_improved_pass2 ok: {ms:.4f} ms per call, {dms:.5f} ms on the device "
        f"vs plain {plain:.3f} ms, bound {bnd:.5f} ms ({by}); at B={WIDE_B}: {ms_w:.4f} ms "
        f"per call, {dms_w:.4f} ms on the device, bound {bnd_w:.4f} ms "
        f"({bnd_w / dms_w:.0%} of it)")

    # K5 banded DP: bit-equal to its wavefront plain version on every lane,
    # finished or abandoned; finished lanes within rtol 3e-4 of dtw_plain
    # (the reference's row DP); abandoned lanes >= their bound
    lap("2 K5 checks")
    db = walks(4096, LENGTH)
    qi = torch.as_tensor(rng.integers(0, N_QUERIES, DTW_CHUNK), device=dev)
    ci = torch.as_tensor(rng.integers(0, db.shape[0], DTW_CHUNK), device=dev)
    err = 0.0
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    cases = []  # (label, queries, candidates, w, qidx, cidx)
    for dt in (torch.float32, torch.float64):
        q2, d2 = qs.to(dt), db.to(dt)
        cases += [(f"chunk {dt}", q2, d2, w, qi, ci),
                  (f"one pair {dt}", q2, d2, w, one, ci[:1].contiguous())]
        small_q, small_c = walks(2, 64, dt), walks(37, 64, dt)
        cases += [(f"2x37 n=64 w={ww} {dt}", small_q, small_c, ww, None, None)
                  for ww in (0, 5, 63, 200)]
        # past the register cap (w + 1 > 512): the shared-memory path
        cases.append((f"2x5 n=1200 w=600 {dt}", walks(2, 1200, dt), walks(5, 1200, dt),
                      600, None, None))
    for label, q2, c2, ww, i2, j2 in cases:
        for p in (1, 2, math.inf):
            what = f"{label} p={p}"
            got = dtw_launch(q2, c2, ww, p, i2, j2)
            want = dtw_wavefront_plain(q2, c2, ww, p, i2, j2)
            check_equal("dtw", got, want, f"{what} vs wavefront plain")
            e = check_close("dtw", got, dtw_plain(q2, c2, ww, p, i2, j2), TOL["dtw"],
                            f"{what} vs dtw_plain")
            err = e if (label == "chunk torch.float32" and p == 1) else err
            lanes = torch.arange(want.numel(), device=dev).reshape(want.shape)
            for bname, bounds in (
                ("BIG", torch.full_like(want, BIG)),
                ("0", torch.zeros_like(want)),
                ("-1", torch.full_like(want, -1.0)),
                # half the lanes get a bound below their distance
                ("half", torch.where(lanes % 2 == 0, want * 0.5, want * 2.0).contiguous()),
            ):
                got = dtw_launch(q2, c2, ww, p, i2, j2, bounds)
                check_equal("dtw", got, dtw_wavefront_plain(q2, c2, ww, p, i2, j2, bounds),
                            f"{what} bounds={bname} vs wavefront plain")
                below = want < bounds
                if bname == "BIG" and not torch.equal(got, want):
                    fail(f"dtw {what}: a bound of BIG changed a lane")
                check_close("dtw", got[below], want[below], 0.0, f"{what} finished lanes")
                if not bool((got[~below] >= bounds[~below]).all()):
                    fail(f"dtw {what} bounds={bname}: abandoned lanes below their bound")
                if bname == "half" and p != math.inf:
                    plain_b = dtw_plain(q2, c2, ww, p, i2, j2, bounds)
                    if not bool((plain_b[~below] >= bounds[~below]).all()):
                        fail(f"dtw plain {what}: abandoned lanes below their bound")
    log(f"[kernel] dtw: {len(cases) * 3} cases x 5 bounds bit-equal to "
        "dtw_wavefront_plain, finished lanes within 3e-4 of dtw_plain")
    lap("2 K5 timing")
    ms = time_ms(lambda: dtw_launch(qs, db, w, 1, qi, ci))
    dms = device_ms(lambda: dtw_launch(qs, db, w, 1, qi, ci))
    ms5 = time_ms(lambda: dtw_launch(qs, db, w, 1, qi[:5].contiguous(), ci[:5].contiguous()))
    plain = time_ms(lambda: dtw_plain(qs, db, w, 1, qi, ci), iters=1, repeats=3, warmup=1)
    wave_plain = time_ms(lambda: dtw_wavefront_plain(qs, db, w, 1, qi, ci),
                         iters=1, repeats=3, warmup=1)
    cells = DTW_CHUNK * (LENGTH * (2 * w + 1) - w * (w + 1))
    bnd, by = bound_ms(4 * DTW_CHUNK * (2 * LENGTH + 1), 5 * cells)
    # the dependency chain: one step's latency from the slope of a one-pair,
    # w = 0 launch (one live cell per warp) between n and 2n
    long_q, long_c = walks(1, 2 * LENGTH), walks(1, 2 * LENGTH)
    t1 = time_ms(lambda: dtw_launch(long_q[:, :LENGTH].contiguous(),
                                    long_c[:, :LENGTH].contiguous(), 0, 1))
    t2 = time_ms(lambda: dtw_launch(long_q, long_c, 0, 1))
    t_step_ms = (t2 - t1) / (2 * LENGTH)
    chain_ms = (2 * LENGTH - 1) * t_step_ms
    del db
    # dense: phase 3's brute force shape, 2 queries x 100,000 rows
    rows = walks(N_ROWS, LENGTH)
    dense_ms = time_ms(lambda: dtw_launch(qs[:2].contiguous(), rows, w, 1),
                       iters=3, repeats=3, warmup=1)
    dense_cells = 2 * N_ROWS * (LENGTH * (2 * w + 1) - w * (w + 1))
    dense_bnd, dense_by = bound_ms(4 * (2 * LENGTH + N_ROWS * LENGTH + 2 * N_ROWS),
                                   5 * dense_cells)
    del rows
    rec["dtw"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                      bound_by=by, library_ms=None, device_ms=dms,
                      shape=f"pairs={DTW_CHUNK} n={LENGTH} w={w} p=1 full DP",
                      ms_5_pairs=ms5, wavefront_plain_ms=wave_plain,
                      chain_bound_ms=chain_ms, t_step_ns=t_step_ms * 1e6,
                      t_step_source=f"slope of a one-pair w=0 launch, n={LENGTH} to {2 * LENGTH}",
                      dense_ms=dense_ms, dense_bound_ms=dense_bnd, dense_bound_by=dense_by,
                      dense_shape=f"2 x {N_ROWS} n={LENGTH} w={w} p=1")
    log(f"[kernel] dtw ok: {ms:.4f} ms at {DTW_CHUNK} pairs, {ms5:.4f} ms at 5 pairs "
        f"vs plain {plain:.3f} ms (wavefront plain {wave_plain:.3f} ms); bound "
        f"{bnd:.5f} ms ({by}); chain bound {chain_ms:.4f} ms = {2 * LENGTH - 1} steps "
        f"x {t_step_ms * 1e6:.2f} ns; dense 2 x {N_ROWS} {dense_ms:.3f} ms, bound "
        f"{dense_bnd:.3f} ms ({dense_by})")
    torch.cuda.synchronize()
    return rec


def phase_kernels_lb(dev, rec):
    """K6, K7, K4, K5's masked entry with the merge and the merge kernel
    against their plain versions; adds to ``rec``."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import random_walks
    from repro_torch.kernels.block_merge.ops import block_merge_launch, block_merge_plain
    from repro_torch.kernels.common import BIG
    from repro_torch.kernels.dtw.ops import (
        dtw_launch,
        dtw_masked_prepare,
        dtw_merge_launch,
        dtw_merge_plain,
        dtw_plain,
        dtw_wavefront_plain,
    )
    from repro_torch.kernels.envelope.ops import envelope_launch, envelope_op
    from repro_torch.kernels.lb_fused.ops import (
        fused_smem_bytes,
        lb_fused_launch,
        lb_fused_plain,
        lb_fused_prepare,
        lb_fused_stage_plain,
    )
    from repro_torch.kernels.lb_improved.ops import combine_passes, lb_improved_pass2_launch
    from repro_torch.kernels.lb_keogh import (
        lb_keogh_launch,
        lb_keogh_stream_launch,
        lb_keogh_stream_plain,
        materialize_windows,
        stream_tile,
    )
    from repro_torch.kernels.lb_kim.ops import (
        lb_kim_features_launch,
        lb_kim_features_plain,
        lb_kim_launch,
        lb_kim_plain,
    )
    from repro_torch.kernels.tuning import KernelConfig, search_space

    rng = np.random.default_rng(SEED + 3)
    w = LENGTH // 10
    nq, b, n = N_QUERIES, BLOCK, LENGTH

    def walks(count, length, dtype=torch.float32):
        return torch.as_tensor(random_walks(rng, count, length), device=dev).to(dtype)

    qs = walks(nq, n)
    cands = walks(b, n)
    upper, lower = envelope_launch(qs, w)

    lap("2 K6")
    # K6 LB_Kim: bit-equal at every p, mask, dtype and tile, at B = 1, 37
    # and 1,024 rows of n = 37, 1,000 and 1,001, on rows as allocated and on
    # the same buffer viewed one value further on.  There, at n = 1,000, no
    # row starts 16-byte aligned: the feature phase's scalar path, in
    # several batches of 256 values a lane; at n = 37 and 1,001 the vector
    # and scalar paths alternate between rows.  Its feature phase alone
    # against lb_kim_features_plain
    kim_cases = 0
    for dt in (torch.float32, torch.float64):
        for nb_k, n_k in ((1, 37), (37, 37), (1, LENGTH), (37, LENGTH), (WIDE_B, LENGTH),
                          (37, LENGTH + 1)):
            rows = walks(nb_k + 6, n_k, dt)
            shifted = rows.reshape(-1)[1:1 + (nb_k + 5) * n_k].view(nb_k + 5, n_k)
            mk = torch.as_tensor(rng.random((5, nb_k)) < 0.6, device=dev)
            for label, src in (("", rows), (" one value on", shifted)):
                ck, qk = src[:nb_k], src[nb_k:nb_k + 5]
                what = f"B={nb_k} n={n_k} {dt}{label}"
                for p in (1, 2, math.inf):
                    for m in (None, mk, mk.to(dt)):
                        got = lb_kim_launch(ck, qk, m, p)
                        check_equal("lb_kim", got, lb_kim_plain(ck, qk, m, p), f"p={p} {what}")
                        for cfg in search_space("lb_kim"):
                            check_equal("lb_kim", lb_kim_launch(ck, qk, m, p, cfg.tile_b), got,
                                        f"tile_b={cfg.tile_b} p={p} {what}")
                        kim_cases += 1
                for cfg in search_space("lb_kim"):
                    check_equal("lb_kim_features", lb_kim_features_launch(ck, cfg.tile_b),
                                lb_kim_features_plain(ck), f"tile_b={cfg.tile_b} {what}")
    # timed at the main path's Q=16, B=32 and at B=1,024, beside an empty
    # kernel (torch.cuda._sleep(0): a launch that spins for no cycle), the
    # floor of any launch's device time
    ms = time_ms(lambda: lb_kim_launch(cands, qs, None, 1))
    dms = device_ms(lambda: lb_kim_launch(cands, qs, None, 1))
    plain = time_ms(lambda: lb_kim_plain(cands, qs, None, 1), iters=10)
    empty = device_ms(lambda: torch.cuda._sleep(0), what="empty kernel")
    wide_k = walks(WIDE_B, n)
    ms_w = time_ms(lambda: lb_kim_launch(wide_k, qs, None, 1))
    dms_w = device_ms(lambda: lb_kim_launch(wide_k, qs, None, 1))
    # bytes: each row read once, one value written per pair; operations:
    # two compares a value, about ten a pair
    bnd, by = bound_ms(4 * (b * n + nq * n + nq * b), 2 * (b + nq) * n + 10 * nq * b)
    bnd_w, by_w = bound_ms(4 * (WIDE_B * n + nq * n + nq * WIDE_B),
                           2 * (WIDE_B + nq) * n + 10 * nq * WIDE_B)
    rec["lb_kim"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=None, device_ms=dms, empty_kernel_device_ms=empty,
                         shape=f"Q={nq} B={b} n={n} p=1", ms_B1024=ms_w,
                         device_ms_B1024=dms_w, bound_ms_B1024=bnd_w, bound_by_B1024=by_w)
    log(f"[kernel] lb_kim ok (bit-equal, {kim_cases} cases x every tile_b, the feature "
        f"phase too): {ms:.4f} ms per call, {dms:.5f} ms on the device vs plain "
        f"{plain:.3f} ms, bound {bnd:.6f} ms ({by}), an empty kernel {empty:.5f} ms on the "
        f"device; at B={WIDE_B}: {ms_w:.4f} ms per call, {dms_w:.5f} ms on the device, "
        f"bound {bnd_w:.5f} ms ({bnd_w / dms_w:.0%} of it)")
    # the feature phase alone at the search's shape: the 16 queries' features
    ms = time_ms(lambda: lb_kim_features_launch(qs))
    dms = device_ms(lambda: lb_kim_features_launch(qs))
    plain = time_ms(lambda: lb_kim_features_plain(qs), iters=10)
    bnd, by = bound_ms(4 * (nq * n + 4 * nq), 2 * nq * n)
    rec["lb_kim_features"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd,
                                  bound_by=by, library_ms=None, device_ms=dms,
                                  shape=f"rows={nq} n={n}")
    log(f"[kernel] lb_kim_features ok (bit-equal, every tile_b): {ms:.4f} ms per call, "
        f"{dms:.5f} ms on the device vs plain {plain:.3f} ms, bound {bnd:.6f} ms ({by})")
    del wide_k

    lap("2 K7 and K7c")
    # K7 stream LB_Keogh: B = 32 windows of a flat segment, hop 1 and 3
    err = 0.0
    for hop in (1, 3):
        seg = walks(1, (b - 1) * hop + n)[0]
        wins = materialize_windows(seg, n, hop)
        for p in (1, 2, math.inf):
            lb, h = lb_keogh_stream_launch(seg, upper, lower, n, hop, p)
            plb, ph = lb_keogh_stream_plain(seg, upper, lower, n, hop, p)
            e = check_close("lb_keogh_stream", lb, plb, TOL["lb_keogh_stream"],
                            f"lb hop={hop} p={p}")
            err = max(err, e) if p == 1 else err
            check_equal("lb_keogh_stream", h, ph, f"H hop={hop} p={p}")
            check_equal("lb_keogh_stream", (lb, h), lb_keogh_launch(wins, upper, lower, p),
                        f"vs K2 on the windows hop={hop} p={p}")
            for cfg in search_space("lb_keogh"):
                check_equal("lb_keogh_stream",
                            lb_keogh_stream_launch(seg, upper, lower, n, hop, p, cfg.tile_b),
                            (lb, h), f"tile_b={cfg.tile_b} hop={hop} p={p}")
                check_equal("lb_keogh", lb_keogh_launch(wins, upper, lower, p,
                                                        tile_b=cfg.tile_b),
                            (lb, h), f"tile_b={cfg.tile_b} p={p}")
    seg64 = walks(1, 40 * 2 + 90, torch.float64)[0]
    q64 = walks(3, 90, torch.float64)
    u64, l64 = envelope_launch(q64, 9)
    lb, h = lb_keogh_stream_launch(seg64, u64, l64, 90, 2, 2)
    plb, ph = lb_keogh_stream_plain(seg64, u64, l64, 90, 2, 2)
    check_close("lb_keogh_stream", lb, plb, TOL["lb_keogh_stream"], "float64")
    check_equal("lb_keogh_stream", h, ph, "float64 H")
    seg = walks(1, (b - 1) + n)[0]
    ms = time_ms(lambda: lb_keogh_stream_launch(seg, upper, lower, n, 1, 1))
    dms = device_ms(lambda: lb_keogh_stream_launch(seg, upper, lower, n, 1, 1))
    plain = time_ms(lambda: lb_keogh_stream_plain(seg, upper, lower, n, 1, 1), iters=10)
    bnd, by = bound_ms(4 * (seg.numel() + 2 * nq * n + nq * b + nq * b * n), 8 * nq * b * n)
    rec["lb_keogh_stream"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                                  bound_by=by, library_ms=None, device_ms=dms,
                                  shape=f"Q={nq} B={b} n={n} hop=1 p=1")
    log(f"[kernel] lb_keogh_stream ok (bit-equal to K2 on the windows, every tile_b): "
        f"{ms:.4f} ms vs plain {plain:.3f} ms, bound {bnd:.5f} ms ({by})")

    # K7c, K7's channel entry: the windows of a (d, L) segment read in
    # place, each a flat row of d channel windows; lb and H bit-equal to K2
    # on the gathered (B, d*n) tile, H to the plain version, lb within
    # 1e-4 of it (bit-equal at p = inf, where no sum is taken)
    err, cases = 0.0, 0
    for dt in (torch.float32, torch.float64):
        for d in (2, 3, 8):
            for n_c in (37, 128, LENGTH):
                qc = walks(4 * d, n_c, dt).reshape(4, d * n_c)
                uc, lc = envelope_op(qc, max(1, n_c // 10), d)
                for hop in (1, 4):
                    segc = walks(d, (b - 1) * hop + n_c + 1, dt)
                    tile = stream_tile(segc, n_c, hop, d).contiguous()
                    for p in (1, 2, math.inf):
                        what = f"d={d} n={n_c} hop={hop} p={p} {dt}"
                        lb, h = lb_keogh_stream_launch(segc, uc, lc, n_c, hop, p, d=d)
                        plb, ph = lb_keogh_stream_plain(segc, uc, lc, n_c, hop, p, d=d)
                        e = check_close("lb_keogh_stream_mv", lb, plb,
                                        TOL["lb_keogh_stream_mv"], what)
                        err = max(err, e) if (dt, p) == (torch.float32, 1) else err
                        if p == math.inf:
                            check_equal("lb_keogh_stream_mv", lb, plb, f"{what} lb")
                        check_equal("lb_keogh_stream_mv", h, ph, f"{what} H")
                        check_equal("lb_keogh_stream_mv", (lb, h),
                                    lb_keogh_launch(tile, uc, lc, p), f"{what} vs K2 on the tile")
                        if (d, n_c, hop) == (3, 128, 4):
                            for cfg in search_space("lb_keogh"):
                                check_equal("lb_keogh_stream_mv", lb_keogh_stream_launch(
                                    segc, uc, lc, n_c, hop, p, cfg.tile_b, d=d), (lb, h),
                                    f"{what} tile_b={cfg.tile_b}")
                        cases += 1
    # timed at the mv stream session's block: Q=4, B=64, (128, 3), hop 4, p=2
    nq_s, b_s, n_s, d_s, hop_s = 4, 64, 128, 3, 4
    qc = walks(nq_s * d_s, n_s).reshape(nq_s, d_s * n_s)
    uc, lc = envelope_op(qc, 12, d_s)
    segc = walks(d_s, (b_s - 1) * hop_s + n_s)
    ms = time_ms(lambda: lb_keogh_stream_launch(segc, uc, lc, n_s, hop_s, 2, d=d_s))
    dms = device_ms(lambda: lb_keogh_stream_launch(segc, uc, lc, n_s, hop_s, 2, d=d_s))
    plain = time_ms(lambda: lb_keogh_stream_plain(segc, uc, lc, n_s, hop_s, 2, d=d_s),
                    iters=10)
    flat = nq_s * b_s * d_s * n_s
    bnd, by = bound_ms(4 * (segc.numel() + 2 * nq_s * d_s * n_s + nq_s * b_s + flat), 8 * flat)
    rec["lb_keogh_stream_mv"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
        device_ms=dms, shape=f"Q={nq_s} B={b_s} d={d_s} n={n_s} hop={hop_s} p=2",
        tolerance="bit-equal to K2 on the gathered tile; H bit-equal and lb rtol 1e-4 to "
                  "the plain version (bit-equal at p = inf)")
    log(f"[kernel] lb_keogh_stream_mv ok ({cases} cases: d in {{2, 3, 8}}, n in {{37, 128, "
        f"{LENGTH}}}, hop in {{1, 4}}, p in {{1, 2, inf}}, float32 and float64; bit-equal "
        f"to K2 on the gathered tile, every tile_b): {ms:.4f} ms per call, {dms:.5f} ms on "
        f"the device vs plain {plain:.3f} ms, bound {bnd:.6f} ms ({by})")

    lap("2 K4")
    # K4 fused LB, one warp per pair: bounds at each query's median lb1
    # (about half the lanes reach pass 2), query 0 with no live lane, read
    # through a stride as the host loop reads a top-k column; bit-equal to
    # K2 + K3 under every schedule that fits, with the stage output
    def fused_case(c, q, u, l, ww, p, what, skip_query0=True, schedules=None):
        lb1_k2, h = lb_keogh_launch(c, u, l, p)
        top = torch.stack([lb1_k2.median(dim=1).values] * 2, dim=1).contiguous()
        if skip_query0:
            top[0] = 0.0
        bounds = top[:, -1]
        real = max(c.shape[0] - 3, 1)
        lb1, lb, stage = lb_fused_launch(c, q, u, l, ww, bounds, p, stage=True, real=real)
        live = lb1 < bounds[:, None]
        if skip_query0 and bool(live[0].any()):
            fail(f"lb_fused {what}: query 0 has a live lane")
        ww = min(ww, c.shape[1] - 1)
        want = combine_passes(lb1_k2, lb_improved_pass2_launch(h, q, ww, p), p)
        want = (lb1_k2, torch.where(live, want, lb1_k2))
        check_equal("lb_fused", (lb1, lb), want, f"vs K2 + K3 {what}")
        check_equal("lb_fused", stage, lb_fused_stage_plain(*want, bounds, real),
                    f"stage {what}")
        plb1, plb = lb_fused_plain(c, q, u, l, ww, torch.full_like(bounds, math.inf), p)
        check_close("lb_fused", lb1, plb1, TOL["lb_keogh"], f"lb1 {what}")
        e = check_close("lb_fused", lb[live], plb[live], TOL["lb_fused"], f"lb {what}")
        check_equal("lb_fused", lb[~live], lb1[~live], f"dead lanes {what}")
        ran = 0
        for cfg in schedules or search_space("lb_fused"):
            need = fused_smem_bytes(c.shape[1], ww, cfg.tile_b, cfg.grid, c.element_size())
            if need > 232_448:
                continue  # the sweep records it as not runnable
            check_equal("lb_fused", lb_fused_launch(c, q, u, l, ww, bounds, p, cfg.tile_b,
                                                    cfg.depth, cfg.grid, stage=True,
                                                    real=real),
                        (lb1, lb, stage), f"{cfg} {what}")
            ran += 1
        if not ran:
            fail(f"lb_fused {what}: no schedule fits")
        return bounds, int(live.sum()), e

    err = 0.0
    for p in (1, 2):
        bounds, live, e = fused_case(cands, qs, upper, lower, w, p, f"p={p}")
        err = e if p == 1 else err
    c37 = walks(37, 200, torch.float64)
    q5 = walks(5, 200, torch.float64)
    u5, l5 = envelope_launch(q5, 20)
    cases = 2
    for p in (1, 2):
        fused_case(c37, q5, u5, l5, 20, p, f"float64 ragged p={p}")
        for cc, qq, ww in ((walks(3, 2), walks(1, 2), 1), (walks(33, 64), walks(3, 64), 0),
                           (walks(5, 300, torch.float64), walks(2, 300, torch.float64), 299),
                           # narrow windows (2w + 1 <= the chunk, scanned directly)
                           # and the first band that is built by chunks
                           (walks(9, 1000), walks(2, 1000), 16),
                           (walks(9, 1000), walks(2, 1000), 17)):
            uu, ll = envelope_op(qq, ww)  # w = 0: (qq, qq), no launch
            fused_case(cc, qq, uu, ll, ww, p, f"{tuple(cc.shape)} w={ww} p={p}",
                       skip_query0=qq.shape[0] > 1)
            cases += 1
        # long rows: one warp's buffers take most of shared memory
        cl, ql = walks(3, 8000), walks(2, 8000)
        ul, ll = envelope_launch(ql, 800)
        fused_case(cl, ql, ul, ll, 800, p, f"n=8000 w=800 p={p}",
                   schedules=[KernelConfig(tile_b=1, grid=g) for g in ("qb", "bq")])
        cases += 2
    log(f"[kernel] lb_fused: {cases + 1} shapes bit-equal to K2 + K3 with the stage, "
        "every schedule that fits")
    bounds, live, _ = fused_case(cands, qs, upper, lower, w, 1, "timed", skip_query0=False)
    ms = time_ms(lambda: lb_fused_launch(cands, qs, upper, lower, w, bounds, 1, stage=True))
    dms = device_ms(lambda: lb_fused_launch(cands, qs, upper, lower, w, bounds, 1,
                                            stage=True))
    plain = time_ms(lambda: lb_fused_plain(cands, qs, upper, lower, w, bounds, 1), iters=10)
    # the two kernels K4 stands for: K2 then K3
    pair = time_ms(lambda: lb_improved_pass2_launch(
        lb_keogh_launch(cands, upper, lower, 1)[1], qs, w, 1))
    # main-path-like: bounds at each query's 2.5% quantile of lb1
    sparse = torch.quantile(lb_keogh_launch(cands, upper, lower, 1)[0], 0.025,
                            dim=1).contiguous()
    sparse_live = int((lb_keogh_launch(cands, upper, lower, 1)[0] < sparse[:, None]).sum())
    ms_sparse = time_ms(lambda: lb_fused_launch(cands, qs, upper, lower, w, sparse, 1,
                                                stage=True))
    dms_sparse = device_ms(lambda: lb_fused_launch(cands, qs, upper, lower, w, sparse, 1,
                                                   stage=True))
    # pass 1 alone: bounds of 0 leave no lane live
    zero = torch.zeros_like(sparse)
    dms_dead = device_ms(lambda: lb_fused_launch(cands, qs, upper, lower, w, zero, 1,
                                                 stage=True))
    by_schedule = {}
    for cfg in search_space("lb_fused"):
        if fused_smem_bytes(n, w, cfg.tile_b, cfg.grid, 4) <= 232_448:
            by_schedule[f"{cfg.tile_b}/{cfg.grid}"] = device_ms(
                lambda cfg=cfg: lb_fused_launch(cands, qs, upper, lower, w, sparse, 1,
                                                cfg.tile_b, 1, cfg.grid, stage=True))
    bnd, by = bound_ms(4 * (b * n + 3 * nq * n + nq + 2 * nq * b) + nq * b,
                       8 * nq * b * n + 12 * live * n)
    rec["lb_fused"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                           library_ms=None, device_ms=dms, k2_k3_ms=pair,
                           ms_sparse=ms_sparse, device_ms_sparse=dms_sparse,
                           device_ms_no_live_lane=dms_dead,
                           device_ms_by_schedule_sparse=by_schedule,
                           shape=f"Q={nq} B={b} n={n} w={w} p=1, {live} of {nq * b} "
                                 f"lanes live (sparse: {sparse_live})")
    log(f"[kernel] lb_fused ok (bit-equal to K2 + K3, every schedule): {ms:.4f} ms per "
        f"call, {dms:.4f} ms on the device ({live} live lanes; {ms_sparse:.4f} / "
        f"{dms_sparse:.4f} ms at the 2.5% quantile, {sparse_live} live; {dms_dead:.4f} ms "
        f"on the device with no live lane) vs K2 + K3 "
        f"{pair:.4f} ms, plain {plain:.3f} ms, bound {bnd:.5f} ms ({by}); device ms "
        f"by schedule {by_schedule}")

    # K4's kim entry (the kim_improved loop): LB_Kim first, from K6's query
    # features and the candidate's extrema taken in pass 1's sweep.  Every
    # other candidate is moved far off, so LB_Kim prunes it; the bound is
    # each query's 75% quantile of the near candidates' lb1.  lb1, lb and
    # the stage bit-equal to K6's plain LB_Kim, then K2 + K3, at every
    # schedule that fits (the long-row path: phase_long_rows)
    def kim_case(c, q, u, l, ww, p, what):
        c = c.clone()
        c[::2] += 100.0 * c.shape[1]
        ww = min(ww, c.shape[1] - 1)
        lb1_k2, h = lb_keogh_launch(c, u, l, p)
        bounds = torch.stack([torch.quantile(lb1_k2[:, 1::2].double(), 0.75, dim=1)
                              .to(c.dtype)] * 2, dim=1).contiguous()[:, -1]
        real = c.shape[0] - 1
        kim = lb_kim_plain(c, q, None, p)
        live = (kim < bounds[:, None]) & (lb1_k2 < bounds[:, None])
        lb = torch.where(live, combine_passes(lb1_k2, lb_improved_pass2_launch(h, q, ww, p),
                                              p), lb1_k2)
        want = (lb1_k2, lb, lb_fused_stage_plain(lb1_k2, lb, bounds, real, kim))
        st = want[2][:, :real]
        if not (bool((st == 0).any()) and bool((st >= 2).any())):
            fail(f"lb_fused kim entry {what}: the check prunes nothing by LB_Kim or sends "
                 "nothing to pass 2")
        ran = 0
        for tile_b, grid in [(None, None)] + [(cfg.tile_b, cfg.grid)
                                              for cfg in search_space("lb_fused")]:
            if tile_b and fused_smem_bytes(c.shape[1], ww, tile_b, grid,
                                           c.element_size()) > 232_448:
                continue
            got = lb_fused_launch(c, q, u, l, ww, bounds, p, tile_b,
                                  None if tile_b is None else 1, grid, stage=True,
                                  real=real, kim=True)
            check_equal("lb_fused", got, want, f"kim entry tile_b={tile_b} grid={grid} {what}")
            ran += 1
        return ran

    kim_runs = 0
    for p in (1, 2):
        kim_runs += kim_case(cands, qs, upper, lower, w, p, f"p={p}")
        kim_runs += kim_case(c37, q5, u5, l5, 20, p, f"float64 ragged p={p}")
        for cc, qq, ww in ((walks(33, 64), walks(3, 64), 0),
                           (walks(9, 1000), walks(2, 1000), 17)):
            uu, ll = envelope_op(qq, ww)
            kim_runs += kim_case(cc, qq, uu, ll, ww, p, f"{tuple(cc.shape)} w={ww} p={p}")
    # timed on the main path's data (no candidate moved: at p = 1 LB_Kim
    # prunes none of them) at the 2.5% quantile, as the loop launches it
    # (prepared once: the query features are computed before the timing),
    # beside the same launcher without the entry
    st_k = torch.empty((nq, b), dtype=torch.uint8, device=dev)
    run_kim = lb_fused_prepare(qs, upper, lower, w, sparse, 1, b, st_k, kim=True)
    run_nokim = lb_fused_prepare(qs, upper, lower, w, sparse, 1, b, st_k)
    ms_kim = time_ms(lambda: run_kim(cands))
    dms_kim = device_ms(lambda: run_kim(cands))
    dms_nokim = device_ms(lambda: run_nokim(cands))
    rec["lb_fused"].update(ms_kim_sparse=ms_kim, device_ms_kim_sparse=dms_kim,
                           device_ms_sparse_same_turn=dms_nokim)
    log(f"[kernel] lb_fused kim entry ok ({kim_runs} launches bit-equal to K6's plain "
        f"LB_Kim then K2 + K3, every schedule that fits, both grids): at the 2.5% quantile "
        f"{ms_kim:.4f} ms per call, {dms_kim:.5f} ms on the device (without the entry "
        f"{dms_nokim:.5f})")

    def merge_state(q_count, k=1, dtype=torch.float32, fill=BIG):
        """An empty top-k and zero counters for the merge."""
        return (torch.full((q_count, k), fill, dtype=dtype, device=dev),
                torch.full((q_count, k), -1, dtype=torch.int64, device=dev),
                torch.zeros((3, q_count), dtype=torch.int64, device=dev),
                torch.zeros(4, dtype=torch.int64, device=dev))

    lap("2 K5 masked and merge")
    # K5's masked-dense entry (with its merge): the survivors of a K4
    # launch at each query's 25% quantile, bit-equal to the pair-list
    # entry; dead slots keep their NaN
    db = cands
    quart = torch.quantile(lb_keogh_launch(db, upper, lower, 1)[0], 0.25, dim=1).contiguous()
    _, _, stage = lb_fused_launch(db, qs, upper, lower, w, quart, 1, stage=True)
    qi, ci = (t.contiguous() for t in (stage == 2).nonzero(as_tuple=True))
    if qi.numel() == 0:
        fail("dtw masked: the check has no live slot")
    top = torch.stack([quart, quart], dim=1).contiguous()
    for p in (1, 2, math.inf):
        for bname, bnds in (("none", None), ("top-k column", top[:, -1])):
            out = torch.full((nq, b), math.nan, device=dev)
            got = dtw_merge_launch(qs, db, stage, w, p, bnds, out, *merge_state(nq), 0,
                                   DTW_CHUNK)
            pb = None if bnds is None else bnds[qi].contiguous()
            check_equal("dtw_merge", got[qi, ci], dtw_launch(qs, db, w, p, qi, ci, pb),
                        f"masked p={p} bounds={bname} vs pair list")
            if not bool(got[stage != 2].isnan().all()):
                fail(f"dtw_merge p={p}: a dead slot was written")
    log("[kernel] dtw_merge masked slots ok (bit-equal to the pair list, dead slots "
        "untouched)")
    _, _, stage = lb_fused_launch(db, qs, upper, lower, w, sparse, 1, stage=True)
    nlive = int((stage == 2).sum())
    out = torch.empty((nq, b), device=dev)

    # block_merge: bit-equal to its plain version, ties included, over
    # three blocks; 40 queries loop over 32 warps
    def merge_inputs(q_count, k, nb, dtype):
        top_v = torch.as_tensor(np.sort(rng.integers(0, 4, (q_count, k)) * 0.5, axis=1),
                                dtype=dtype, device=dev)
        top_v[0] = BIG
        top_i = torch.as_tensor(rng.integers(0, 1000, (q_count, k)), device=dev)
        st = torch.as_tensor(rng.choice(np.array([0, 1, 2, 2, 255], np.uint8),
                                        size=(q_count, nb)), device=dev)
        dv = torch.as_tensor(rng.integers(0, 5, (q_count, nb)) * 0.5, dtype=dtype,
                             device=dev)
        dv[st != 2] = math.nan
        counts = torch.zeros((3, q_count), dtype=torch.int64, device=dev)
        totals = torch.zeros(4, dtype=torch.int64, device=dev)
        return top_v, top_i, counts, totals, st, dv

    for q_count, k, dtype in ((16, 1, torch.float32), (16, 5, torch.float32),
                              (40, 5, torch.float64), (1, 3, torch.float32)):
        got = merge_inputs(q_count, k, 37, dtype)
        want = tuple(t.clone() for t in got)
        for lo in (0, 37, 74):
            block_merge_launch(*got, lo, DTW_CHUNK)
            block_merge_plain(*want, lo, DTW_CHUNK)
        check_equal("block_merge", got[:4], want[:4], f"Q={q_count} k={k} {dtype}")
    # timed at the main path's shape: the survivors of the K4 launch above
    dv = dtw_merge_launch(qs, db, stage, w, 1, None, torch.empty((nq, b), device=dev),
                          *merge_state(nq), 0, DTW_CHUNK)
    state = merge_state(nq)
    ms = time_ms(lambda: block_merge_launch(*state, stage, dv, 0, DTW_CHUNK))
    dms = device_ms(lambda: block_merge_launch(*state, stage, dv, 0, DTW_CHUNK))
    plain = time_ms(lambda: block_merge_plain(*state, stage, dv, 0, DTW_CHUNK), iters=10)
    bnd, by = bound_ms(nq * b + 4 * nlive + 2 * nq * (4 + 8) + 2 * 8 * (3 * nq + 4),
                       nq * b + nlive)
    rec["block_merge"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd,
                              bound_by=by, library_ms=None, device_ms=dms,
                              shape=f"Q={nq} k=1 B={b}, {nlive} live slots")
    log(f"[kernel] block_merge ok (bit-equal, ties included): {ms:.4f} ms per call, "
        f"{dms:.4f} ms on the device vs plain {plain:.3f} ms, bound {bnd:.6f} ms ({by})")

    # K5's masked entry with the merge (dtw_merge): bit-equal to the
    # masked plain version (the kernel's wavefront DP) then the merge's,
    # block after block, bounds read from the top-k being merged
    def merge_case(q_count, k, dtype, bounded, nb_m, n_m, w_m, seed):
        g = np.random.default_rng(seed)
        base = walks(6, n_m, dtype)
        q_m = base[torch.as_tensor(g.integers(0, 6, q_count), device=dev)].contiguous()
        st = torch.empty((q_count, nb_m), dtype=torch.uint8, device=dev)
        got = list(merge_state(q_count, k, dtype))
        want = [t.clone() for t in got]
        out_m = torch.full((q_count, nb_m), math.nan, dtype=dtype, device=dev)
        out_w = out_m.clone()
        run = dtw_masked_prepare(q_m, w_m, 1, st, got[0][:, -1] if bounded else None,
                                 out_m, merge=(*got, DTW_CHUNK))
        # random stages, an all-dead block, random again, a ragged tail;
        # rows repeat, and queries are rows: DP values tie
        for t in range(4):
            c_m = base[torch.as_tensor(g.integers(0, 6, nb_m), device=dev)].contiguous()
            sv = g.choice(np.array([0, 1, 2, 2], np.uint8), size=(q_count, nb_m))
            if t == 1:
                sv = g.choice(np.array([0, 1], np.uint8), size=(q_count, nb_m))
            if t == 3:
                sv[:, nb_m - 5:] = 255
            st.copy_(torch.as_tensor(sv, device=dev))
            run(c_m, t * nb_m)
            dtw_merge_plain(q_m, c_m, st, w_m, 1, want[0][:, -1] if bounded else None,
                            out_w, *want, t * nb_m, DTW_CHUNK, dp=dtw_wavefront_plain)
            live = st == 2
            what = f"Q={q_count} k={k} {dtype} bounds={bounded} B={nb_m} n={n_m} block {t}"
            check_equal("dtw_merge", out_m[live], out_w[live], f"DP slots {what}")
            check_equal("dtw_merge", tuple(got), tuple(want), f"top-k and counters {what}")
        if int(got[2][2].sum()) == 0:
            fail(f"dtw_merge Q={q_count} k={k}: the check had no survivor")

    merge_cases = 0
    for q_count in (1, 16, 33):
        for k in (1, 5):
            for dtype in (torch.float32, torch.float64):
                for bounded in (False, True):
                    merge_case(q_count, k, dtype, bounded, 37, 64, 6, 70 + merge_cases)
                    merge_cases += 1
    for bounded in (False, True):  # the main path's shape: Q=16, B=32, n, w
        merge_case(nq, 1, torch.float32, bounded, b, n, w, 90 + bounded)
        merge_cases += 1
    # timed at the main path's shape: the survivors of the K4 launch at the
    # 2.5% quantile, merged into a top-1 that takes nothing (values tie);
    # its first launch checked against the plain versions
    mstate = merge_state(nq, fill=-1.0)
    mwant = [t.clone() for t in mstate]
    mrun = dtw_masked_prepare(qs, w, 1, stage, None, out, (*mstate, DTW_CHUNK))
    mrun(db, 0)
    out_w = torch.full_like(out, math.nan)
    dtw_merge_plain(qs, db, stage, w, 1, None, out_w, *mwant, 0, DTW_CHUNK,
                    dp=dtw_wavefront_plain)
    check_equal("dtw_merge", out[stage == 2], out_w[stage == 2], "timed launch DP slots")
    check_equal("dtw_merge", tuple(mstate), tuple(mwant), "timed launch top-k and counters")
    ms = time_ms(lambda: mrun(db, 0))
    dms = device_ms(lambda: mrun(db, 0))
    plain = time_ms(lambda: dtw_merge_plain(qs, db, stage, w, 1, None, out, *mstate, 0,
                                            DTW_CHUNK, dp=dtw_plain),
                    iters=3, repeats=3, warmup=1)
    # ops: the live pairs' band cells; bytes: their rows, the stage, the
    # top-k and counters
    cells = nlive * (n * (2 * w + 1) - w * (w + 1))
    bnd, by = bound_ms(4 * (nq * n + b * n + nlive) + nq * b + 2 * nq * (4 + 8)
                       + 2 * 8 * (3 * nq + 4), 5 * cells)
    rec["dtw_merge"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd,
                            bound_by=by, library_ms=None, device_ms=dms,
                            merge_source="src/repro_torch/csrc/block_merge.cuh",
                            shape=f"Q={nq} x B={b} slots, {nlive} live, n={n} w={w} p=1, "
                                  f"k=1; then the merge")
    log(f"[kernel] dtw_merge ok ({merge_cases} cases bit-equal to dtw_masked_plain + "
        f"block_merge_plain, ties, dead and ragged blocks, with and without bounds): "
        f"{ms:.4f} ms per call, {dms:.4f} ms on the device vs plain {plain:.3f} ms, "
        f"bound {bnd:.5f} ms ({by})")

    # the loop's order on the same inputs: K4, then K5 with the merge, 20
    # times; each kernel's device ms there against its time alone above
    # ("not measured" where no profiler session saw the kernels)
    def block():
        lb_fused_launch(cands, qs, upper, lower, w, sparse, 1, stage=True)
        mrun(db, 0)

    def blocks():
        for _ in range(20):
            block()

    block()
    torch.cuda.synchronize()
    seq = {k.split("<")[0].split("::")[-1]: us / 1e3 / c
           for k, (us, c) in profiled_kernels(blocks, "K4 -> K5 sequence").items()}
    # K5 with the merge alternating with a one-value PyTorch fill instead
    one = torch.empty(1, device=dev)

    def filled():
        for _ in range(20):
            one.zero_()
            mrun(db, 0)

    seq["dtw_kernel after a fill"] = next(
        (us / 1e3 / c for k, (us, c) in profiled_kernels(filled, "K5 after a fill").items()
         if "dtw_kernel" in k), "not measured")
    rec["dtw_merge"]["sequence_device_ms"] = seq
    log(f"[kernel] in the loop's order K4 -> K5 with the merge on the same inputs, "
        f"device ms per launch: {seq}")
    torch.cuda.synchronize()


def phase_long_rows(dev, rec):
    """Every kernel past the shared-memory form of K1, K3, K4 and K5, held
    against its plain version, and each long path's time per call, added
    to its kernel's record in ``rec`` under ``long_rows``."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import random_walks
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.common import BIG, KERNEL_DTYPES, kernel_dtype
    from repro_torch.kernels.dtw.ops import (
        dtw_launch,
        dtw_merge_launch,
        dtw_merge_plain,
        dtw_wavefront_plain,
    )
    from repro_torch.kernels.envelope.ops import envelope_launch, envelope_plain
    from repro_torch.kernels.lb_fused.ops import (
        fused_long,
        lb_fused_launch,
        lb_fused_stage_plain,
    )
    from repro_torch.kernels.lb_improved.ops import (
        combine_passes,
        lb_improved_pass2_launch,
        lb_improved_pass2_plain,
    )
    from repro_torch.kernels.lb_keogh import (
        lb_keogh_launch,
        lb_keogh_plain,
        lb_keogh_stream_launch,
        materialize_windows,
    )
    from repro_torch.kernels.lb_kim.ops import lb_kim_launch, lb_kim_plain
    from repro_torch.kernels.tuning import search_space

    rng = np.random.default_rng(SEED + 5)
    lib = cuda_lib.library()
    table = []

    def walks(count, length, dtype):
        return torch.as_tensor(random_walks(rng, count, length), device=dev).to(dtype)

    def timed(kernel, shape, path, fn, nbytes, ops):
        ms = time_ms(fn, iters=3, repeats=3, warmup=1)
        bnd, by = bound_ms(nbytes, ops)
        table.append(dict(kernel=kernel, shape=shape, path=path, ms=ms, bound_ms=bnd,
                          bound_by=by))

    def dtw_path(dt, n, w):
        slots = lib.repro_dtw_slots(KERNEL_DTYPES[dt], n, w, 1)
        if slots > 0:
            return f"register wavefront, {slots} slots a lane"
        if slots == 0:
            return "shared-memory wavefront"
        diag = lib.repro_dtw_workspace(KERNEL_DTYPES[dt], 1, n, w, 1)
        return ("long rows, rows in place, diagonals in " +
                ("the workspace" if diag else "shared memory"))

    def dtw_checks(qs, cands, w, shape, dt):
        """K5's pair list and masked entry with the merge on 2 live pairs,
        bit-equal to the wavefront plain version; timed."""
        n = qs.shape[1]
        qi = torch.tensor([0, 1], device=dev)
        ci = torch.tensor([1, 0], device=dev)
        want = dtw_wavefront_plain(qs, cands, w, 1, qi, ci)
        check_equal("dtw", dtw_launch(qs, cands, w, 1, qi, ci), want,
                    f"{shape} vs wavefront plain")
        stage = torch.zeros((2, cands.shape[0]), dtype=torch.uint8, device=dev)
        stage[0, 1] = stage[1, 0] = 2
        stage[1, 1] = 1
        state = [torch.full((2, 1), BIG, dtype=dt, device=dev),
                 torch.full((2, 1), -1, dtype=torch.int64, device=dev),
                 torch.zeros((3, 2), dtype=torch.int64, device=dev),
                 torch.zeros(4, dtype=torch.int64, device=dev)]
        expect = [t.clone() for t in state]
        out = torch.full((2, cands.shape[0]), math.nan, dtype=dt, device=dev)
        out_want = out.clone()
        dtw_merge_launch(qs, cands, stage, w, 1, None, out, *state, 0, DTW_CHUNK)
        dtw_merge_plain(qs, cands, stage, w, 1, None, out_want, *expect, 0, DTW_CHUNK,
                        dp=dtw_wavefront_plain)
        live = stage == 2
        check_equal("dtw_merge", out[live], out_want[live], f"{shape} DP slots")
        check_equal("dtw_merge", tuple(state), tuple(expect), f"{shape} top-k and counters")
        cells = 2 * (n * (2 * w + 1) - w * (w + 1))
        timed("dtw", f"2 pairs {shape}", dtw_path(dt, n, w),
              lambda: dtw_launch(qs, cands, w, 1, qi, ci),
              qs.element_size() * (4 * n + 4), 5 * cells)

    for n, dtn in LONG_SHAPES:
        dt = getattr(torch, dtn)
        isz = torch.empty(0, dtype=dt).element_size()
        for w in (n // 10, n - 1):
            shape = f"n={n} w={w} {dtn}"
            lap(f"2 long {shape}")
            # K1: 3 rows (a block per row where its padded row fits, else a
            # warp per row) and 300 (a warp per row)
            for rows in (3, 300):
                x = walks(rows + 1, n, dt)[1:]  # a base off 16-byte alignment
                u, l = envelope_launch(x, w)
                pu, pl = envelope_plain(x, w)
                check_close("envelope", u, pu, 0.0, f"U {rows} rows {shape}")
                check_close("envelope", l, pl, 0.0, f"L {rows} rows {shape}")
            ws = lib.repro_envelope_workspace(kernel_dtype(x), 300, n, w)
            timed("envelope", f"300 rows {shape}",
                  "warp per row, buffers in the workspace" if ws else
                  "warp per row, buffers in shared memory",
                  lambda: envelope_launch(x, w), 3 * x.numel() * isz, 6 * x.numel())
            del x, u, l, pu, pl
            # K2, K3, K6, K7 on Q=2 queries, B=5 candidates
            qs, cands = walks(2, n, dt), walks(5, n, dt)
            upper, lower = envelope_launch(qs, w)
            for p in (1, 2, math.inf):
                lb, h = lb_keogh_launch(cands, upper, lower, p)
                plb, ph = lb_keogh_plain(cands, upper, lower, p)
                check_close("lb_keogh", lb, plb, TOL["lb_keogh"], f"lb p={p} {shape}")
                check_close("lb_keogh", h, ph, 0.0, f"H p={p} {shape}")
                check_close("lb_improved_pass2", lb_improved_pass2_launch(h, qs, w, p),
                            lb_improved_pass2_plain(h, qs, w, p), TOL["lb_improved_pass2"],
                            f"p={p} {shape}")
                # K6 at every tile, also on the candidates' buffer viewed one
                # value on (no row start 16-byte aligned: the scalar path)
                for label, ck in (("", cands),
                                  (" one value on", cands.reshape(-1)[1:1 + 4 * n].view(4, n))):
                    want = lb_kim_plain(ck, qs, None, p)
                    for tile in (None, *(cfg.tile_b for cfg in search_space("lb_kim"))):
                        check_equal("lb_kim", lb_kim_launch(ck, qs, None, p, tile), want,
                                    f"tile_b={tile} p={p} {shape}{label}")
                seg = walks(1, 4 * 3 + n, dt)[0]  # windows at hop 3: not 16-byte aligned
                check_equal("lb_keogh_stream", lb_keogh_stream_launch(seg, upper, lower, n, 3, p),
                            lb_keogh_launch(materialize_windows(seg, n, 3), upper, lower, p),
                            f"hop=3 p={p} {shape}")
            _, h = lb_keogh_launch(cands, upper, lower, 1)
            rows2 = 10
            timed("lb_keogh", f"Q=2 B=5 {shape}", "warp per pair",
                  lambda: lb_keogh_launch(cands, upper, lower, 1),
                  isz * (5 * n + 4 * n + rows2 + rows2 * n), 8 * rows2 * n)
            ws = lib.repro_lb_improved_pass2_workspace(kernel_dtype(h), rows2, n, w)
            timed("lb_improved_pass2", f"Q=2 B=5 {shape}",
                  "warp per row, buffers in the workspace" if ws else
                  "warp per row, buffers in shared memory",
                  lambda: lb_improved_pass2_launch(h, qs, w, 1),
                  isz * (rows2 * n + 2 * n + rows2), 11 * rows2 * n)
            timed("lb_kim", f"Q=2 B=5 {shape}", "warp per row, last block's lanes",
                  lambda: lb_kim_launch(cands, qs, None, 1), isz * (7 * n + rows2), 14 * n)
            timed("lb_keogh_stream", f"Q=2 B=5 hop=3 {shape}", "warp per pair",
                  lambda: lb_keogh_stream_launch(seg, upper, lower, n, 3, 1),
                  isz * (seg.numel() + 4 * n + rows2 + rows2 * n), 8 * rows2 * n)
            # K4: bit-equal to K2 + K3 with the stage, resolved and explicit tiles
            for p in (1, 2):
                klb1, kh = lb_keogh_launch(cands, upper, lower, p)
                bounds = klb1.median(dim=1).values.contiguous()
                live = klb1 < bounds[:, None]
                want = (klb1, torch.where(
                    live, combine_passes(klb1, lb_improved_pass2_launch(kh, qs, w, p), p),
                    klb1))
                stage_want = lb_fused_stage_plain(*want, bounds, 4)
                for tile_b, grid in ((None, None), (1, "qb"), (3, "bq")):
                    got = lb_fused_launch(cands, qs, upper, lower, w, bounds, p, tile_b,
                                          None if tile_b is None else 1, grid, stage=True,
                                          real=4)
                    check_equal("lb_fused", got, (*want, stage_want),
                                f"vs K2 + K3 tile_b={tile_b} grid={grid} p={p} {shape}")
                # the kim entry: candidates 0, 2 and 4 far off (LB_Kim prunes
                # them), the bound at the near ones' larger lb1 (one of them
                # reaches pass 2)
                ck = cands.clone()
                ck[::2] += 100.0 * n
                klb1k, khk = lb_keogh_launch(ck, upper, lower, p)
                bk = klb1k[:, 1::2].max(dim=1).values.contiguous()
                kimk = lb_kim_plain(ck, qs, None, p)
                livek = (kimk < bk[:, None]) & (klb1k < bk[:, None])
                lbk = torch.where(livek, combine_passes(
                    klb1k, lb_improved_pass2_launch(khk, qs, w, p), p), klb1k)
                want_k = (klb1k, lbk, lb_fused_stage_plain(klb1k, lbk, bk, 4, kimk))
                if not (bool((want_k[2] == 0).any()) and bool((want_k[2] == 2).any()
                                                              | (want_k[2] == 3).any())):
                    fail(f"lb_fused kim entry {shape}: the check prunes nothing by LB_Kim "
                         "or sends nothing to pass 2")
                for tile_b, grid in ((None, None), (1, "qb"), (3, "bq")):
                    got = lb_fused_launch(ck, qs, upper, lower, w, bk, p, tile_b,
                                          None if tile_b is None else 1, grid, stage=True,
                                          real=4, kim=True)
                    check_equal("lb_fused", got, want_k,
                                f"kim entry tile_b={tile_b} grid={grid} p={p} {shape}")
            nlive = int(live.sum())
            timed("lb_fused", f"Q=2 B=5 {shape}, {nlive} live",
                  "long rows, buffers in the workspace" if fused_long(n, w, "qb", isz)
                  else "warp per pair, buffers in shared memory",
                  lambda: lb_fused_launch(cands, qs, upper, lower, w, bounds, 1),
                  isz * (5 * n + 6 * n + 2 + 2 * rows2) + rows2,
                  8 * rows2 * n + 12 * nlive * n)
            # K5: the pair list and the masked entry with the merge
            dtw_checks(qs, cands, w, shape, dt)
            del qs, cands, upper, lower, h, seg
    n, w = DTW_LONG
    lap(f"2 long K5 n={n} w={w}")
    dtw_checks(walks(2, n, torch.float32), walks(2, n, torch.float32), w,
               f"n={n} w={w} float32", torch.float32)
    torch.cuda.synchronize()
    for r in table:
        rec[r["kernel"]].setdefault("long_rows", []).append(
            {k: v for k, v in r.items() if k != "kernel"})
    for r in table:
        log(f"[long] {r['kernel']:<18} {r['shape']:<44} {r['path']:<52} "
            f"{r['ms']:.4f} ms per call, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    log(f"[long] every kernel at float32 n={LONG_SHAPES[0][0]} and float64 "
        f"n={LONG_SHAPES[1][0]}, w = n // 10 and n - 1, held against its plain version; "
        f"K5 also at n={n} w={w}")


# ------------------------------------------------------------- phase 3


def device_busy(fn) -> tuple[float, float, dict]:
    """(device ms, host wall ms, {kernel: (ms, count)}) of one call under
    torch.profiler: the self times of the device's kernels and copies,
    and the wall clock around the call (of the session that saw them)."""
    import torch

    wall = []

    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    got = profiled_kernels(run, "profiled search")
    by_kernel = {k: (us / 1e3, c) for k, (us, c) in got.items()}
    return sum(ms for ms, _ in by_kernel.values()), wall[-1], by_kernel


def loop_without_sync(dev, db, queries, res, kim: bool = False) -> tuple[float, float]:
    """The session's search loop (``fused_block_loop``; with ``kim``, that
    of ``kim_improved``; a multivariate session's composed loop) on the
    prepared queries under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    synchronising call; its answers and counters must be the search's
    ``res``.  Returns the host's seconds to enqueue the loop and the
    loop's wall seconds (enqueue, then one synchronise)."""
    import numpy as np
    import torch

    from repro_torch.core.cascade import fused_block_loop
    from repro_torch.core.dtw import finish_cost
    from repro_torch.kernels.envelope.ops import envelope_op

    cfg = db.config
    qs = torch.as_tensor(db.prepare_queries(queries), device=dev)
    qs = qs.to(db.rows_tensor.dtype).contiguous()
    upper, lower = envelope_op(qs, db.w, db.channels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        top_v, top_i, counts, totals = fused_block_loop(
            qs, db.rows_tensor, upper, lower, db.w, cfg.p, cfg.k, cfg.block, 16, kim=kim,
            d=db.channels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    s = res.stats
    dist = finish_cost(top_v.cpu(), cfg.p).numpy()
    if not (np.array_equal(top_i.cpu().numpy(), res.indices)
            and np.array_equal(dist, res.distances)):
        fail("the loop under sync debug mode answered otherwise than the search")
    want = [*s.stage_pruned, s.full_dtw]
    if counts.sum(dim=1).tolist() != want or totals.tolist() != [
            s.blocks_lb2, s.blocks_dtw, s.dp_lane_work, s.dp_lane_useful]:
        fail(f"the loop's counters {counts.sum(dim=1).tolist()} {totals.tolist()} "
             f"differ from the search's {s}")
    return enqueue_s, loop_s


def phase_main_path(dev, launches):
    import numpy as np
    import torch

    from repro_torch.api import Database
    from repro_torch.core.dtw import dtw_reference
    from repro_torch.data.synthetic import random_walks
    from repro_torch.kernels.dtw.ops import dtw_qbatch_op

    rng = np.random.default_rng(SEED)
    x = random_walks(rng, N_ROWS, LENGTH)
    queries = random_walks(rng, N_QUERIES, LENGTH)
    torch.cuda.synchronize()

    def build():
        t0 = time.perf_counter()
        db = Database.build(x)
        torch.cuda.synchronize()
        return db, time.perf_counter() - t0

    db, build_s = counted(launches, "build", build)
    plan = db.plan(queries).explain()
    if not plan.startswith("driver: host"):
        fail(f"default session did not route to the host driver:\n{plan}")

    def search():
        t0 = time.perf_counter()
        res = db.search(queries)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res, search_s = counted(launches, "search", search)
    busy_ms, wall_ms, by_kernel = device_busy(lambda: db.search(queries))
    log(f"[main] {db!r}; build {build_s:.2f} s, search of {N_QUERIES} queries "
        f"{search_s:.2f} s = {N_QUERIES / search_s:.2f} qps")
    log("[main] plan: " + " | ".join(plan.splitlines()[:3]))
    s = res.stats
    log(f"[main] pruned {s.pruned_by}, full_dtw {s.full_dtw} of "
        f"{s.n_candidates}, blocks {s.blocks_total}, DP chunks {s.blocks_dtw}, "
        f"DP lanes {s.dp_lane_useful}/{s.dp_lane_work}")
    log(f"[main] launches: build {launches['build']}; search {launches['search']}")
    if busy_ms > 0:
        log(f"[main] profiled second search: device busy {busy_ms:.1f} ms of "
            f"{wall_ms:.1f} ms wall = idle share {1 - busy_ms / wall_ms:.3f}")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        log("[main] device ms by kernel: " + "; ".join(
            f"{k[:48]} {ms:.1f} ms / {c}" for k, (ms, c) in top))
    else:
        log("[main] profiled second search: the profiler saw no device time; "
            "idle share not measured")
    require_launched(launches, "build", ("envelope", "lb_kim", "lb_keogh",
                                         "lb_improved_pass2", "dtw"), "build")
    require_launched(launches, "search", ("envelope", "lb_fused", "dtw_merge"), "search")
    got = launches["search"]
    per_block = (got["lb_fused"], got["dtw_merge"])
    others = {name: got[name] for name in ("dtw", "block_merge", "lb_keogh",
                                           "lb_improved_pass2", "lb_kim", "lb_kim_features",
                                           "lb_keogh_stream")}
    if per_block != (s.blocks_total,) * 2 or any(others.values()):
        fail(f"search: expected two launches per block ({s.blocks_total} blocks), one "
             f"lb_fused and one dtw_merge, and no standalone merge, dtw, lb_keogh or "
             f"lb_improved_pass2 launch, got {got}")
    enqueue_s, loop_s = loop_without_sync(dev, db, queries, res)
    log(f"[main] the block loop ran again under set_sync_debug_mode('error') in "
        f"{loop_s:.3f} s ({enqueue_s:.3f} s of host time to enqueue its "
        f"{2 * s.blocks_total} launches, {enqueue_s / s.blocks_total * 1e6:.1f} us a "
        f"block): no synchronisation, same indices, distances and counters")
    if s.pruned_by != MAIN_PRUNED or s.full_dtw != MAIN_FULL_DTW:
        fail(f"pruning {s.pruned_by}, full_dtw {s.full_dtw} != recorded "
             f"{MAIN_PRUNED}, {MAIN_FULL_DTW}")
    if res.indices[:2, 0].tolist() != MAIN_TOP1:
        fail(f"top-1 rows {res.indices[:2, 0].tolist()} != recorded {MAIN_TOP1}")

    # top-1 of two queries against a brute force over every row (K5)
    qs = torch.as_tensor(db.prepare_queries(queries[:2]), device=dev)
    brute = dtw_qbatch_op(qs, db.rows_tensor, db.w, db.p)
    best = brute.argmin(dim=1).cpu().numpy()
    if not np.array_equal(best, res.indices[:2, 0]):
        fail(f"top-1 {res.indices[:2, 0]} != brute force {best}")
    log(f"[main] brute force top-1 {best.tolist()} == session top-1")
    # every returned distance against the float64 O(n^2) oracle
    worst = 0.0
    for qi in range(N_QUERIES):
        for j, idx in enumerate(res.indices[qi]):
            ref = dtw_reference(queries[qi], x[idx], db.w, db.p)
            got = float(res.distances[qi, j])
            worst = max(worst, abs(got - ref) / abs(ref))
    if worst > 2e-4:
        fail(f"distance vs float64 dtw_reference: rel err {worst:.3g} > 2e-4")
    log(f"[main] distances vs float64 dtw_reference: max rel err {worst:.3g}")
    return dict(x=x, queries=queries, db=db, res=res, search_s=search_s)


def phase_long_session(dev, launches, main):
    """Long rows end to end: ``Database.build`` of LONG_SESSION's random
    walks (float32, w = n // 10) and a search through the host driver's
    device loop, two launches per block (K4 on its long-row path, K5 with
    the merge), the loop again under sync debug mode; then the same rows'
    first LONG_SCAN_ROWS on the scan route.  Each top-1 must equal a K5
    brute force over all rows."""
    import numpy as np
    import torch

    from repro_torch.api import Database
    from repro_torch.data.synthetic import random_walks
    from repro_torch.kernels.dtw.ops import dtw_qbatch_op

    rng = np.random.default_rng(SEED + 6)
    n_rows, n, nq = LONG_SESSION
    x = random_walks(rng, n_rows, n)
    queries = random_walks(rng, nq, n)
    main_block_ms = main["search_s"] / main["res"].stats.blocks_total * 1e3
    for rows, route, tag in ((n_rows, "host", "long"), (LONG_SCAN_ROWS, "scan", "long_scan")):
        def build():
            t0 = time.perf_counter()
            db = Database.build(x[:rows])
            torch.cuda.synchronize()
            return db, time.perf_counter() - t0

        def search():
            t0 = time.perf_counter()
            res = db.search(queries)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        db, build_s = counted(launches, f"{tag}_build", build)
        plan = db.plan(queries).explain()
        if not plan.startswith(f"driver: {route}"):
            fail(f"{tag} session did not route to the {route} driver:\n{plan}")
        res, search_s = counted(launches, f"{tag}_search", search)
        s = res.stats
        got = launches[f"{tag}_search"]
        what = f"{rows} x {n} float32 w={db.w}"
        if route == "host":
            others = {k: v for k, v in got.items() if k not in ("envelope", "lb_fused",
                                                                  "dtw_merge")}
            if (got["lb_fused"], got["dtw_merge"]) != (s.blocks_total,) * 2 or any(
                    others.values()):
                fail(f"{tag} search: expected two launches per block ({s.blocks_total} "
                     f"blocks), one lb_fused and one dtw_merge, got {got}")
            enqueue_s, loop_s = loop_without_sync(dev, db, queries, res)
            log(f"[long] {what}: build {build_s:.2f} s, search of {nq} queries "
                f"{search_s:.3f} s, {s.blocks_total} blocks of two launches, "
                f"{search_s / s.blocks_total * 1e3:.3f} ms a block (default session "
                f"{main_block_ms:.4f} ms a block); the loop under "
                f"set_sync_debug_mode('error') {loop_s:.3f} s, same answers and counters")
        else:
            require_launched(launches, f"{tag}_search", ("lb_keogh", "lb_improved_pass2",
                                                         "dtw"), f"{tag} search")
            log(f"[long] {what} on the scan route: build {build_s:.2f} s, search of {nq} "
                f"queries {search_s:.3f} s")
        log(f"[long]   pruned {s.pruned_by}, full_dtw {s.full_dtw} of {s.n_candidates}; "
            f"launches: build {launches[f'{tag}_build']}; search {got}")
        qs = torch.as_tensor(db.prepare_queries(queries), device=dev)
        best = dtw_qbatch_op(qs, db.rows_tensor, db.w, db.p).argmin(dim=1).cpu().numpy()
        if not np.array_equal(best, res.indices[:, 0]):
            fail(f"{tag}: top-1 {res.indices[:, 0]} != brute force {best}")
        log(f"[long]   brute force top-1 {best.tolist()} == session top-1")
        del db, res


# ------------------------------------------------------------- phase 4


def phase_scan_sessions(dev, launches):
    import numpy as np

    from repro_torch.api import Database, SearchConfig
    from repro_torch.core.pipeline import PIPELINES
    from repro_torch.data.synthetic import random_walks

    rng = np.random.default_rng(SEED + 2)
    x = random_walks(rng, 768, 128)
    queries = random_walks(rng, 8, 128)

    def scan_all():
        out = {}
        for method in PIPELINES:
            cfg = SearchConfig(k=5, method=method)
            gpu = Database.build(x, cfg, device=dev)
            if not gpu.plan(queries).explain().startswith("driver: scan"):
                fail(f"{method}: small session did not route to the scan driver")
            out[method] = gpu.search(queries)
        return out

    on_gpu = counted(launches, "scan", scan_all)
    for method, rg in on_gpu.items():
        rc = Database.build(x, SearchConfig(k=5, method=method), device="cpu").search(queries)
        if not np.array_equal(rg.indices, rc.indices):
            fail(f"{method}: scan indices differ between cuda and cpu")
        if not np.allclose(rg.distances, rc.distances, rtol=2e-4, atol=0):
            fail(f"{method}: scan distances differ beyond rtol 2e-4")
        sg, sc = rg.stats, rc.stats
        log(f"[scan] {method:<12} cuda pruned={sg.stage_pruned} dtw={sg.full_dtw} "
            f"lanes={sg.dp_lane_useful}/{sg.dp_lane_work} | cpu "
            f"pruned={sc.stage_pruned} dtw={sc.full_dtw} "
            f"lanes={sc.dp_lane_useful}/{sc.dp_lane_work}")
    log(f"[scan] launches: {launches['scan']}")
    require_launched(launches, "scan", ("envelope", "lb_kim", "lb_keogh",
                                        "lb_improved_pass2", "dtw"), "scan driver")


def phase_stream(dev, launches):
    """The stream form of LB_Improved (K7 then K3) over the hop-strided
    windows of one flat segment, against 16 templates."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import random_walks
    from repro_torch.kernels.envelope.ops import envelope_op
    from repro_torch.kernels.lb_improved.ops import (
        lb_improved_stream_plain,
        lb_improved_stream_qbatch_op,
    )

    rng = np.random.default_rng(SEED + 4)
    n, w, hop, windows = LENGTH, LENGTH // 10, 8, 1024
    seg = torch.as_tensor(random_walks(rng, 1, (windows - 1) * hop + n)[0], device=dev)
    templates = torch.as_tensor(random_walks(rng, N_QUERIES, n), device=dev)

    def run():
        upper, lower = envelope_op(templates, w)
        got = lb_improved_stream_qbatch_op(seg, templates, upper, lower, n, w, hop, 1)
        torch.cuda.synchronize()
        return got, upper, lower

    got, upper, lower = counted(launches, "stream", run)
    want = lb_improved_stream_plain(seg, templates, upper, lower, n, w, hop, 1)
    check_close("lb_improved_stream", got, want, TOL["lb_improved_pass2"],
                f"{windows} windows hop={hop}")
    log(f"[stream] LB_Improved of {N_QUERIES} templates x {windows} windows "
        f"(hop {hop}) matches the plain version; launches {launches['stream']}")
    require_launched(launches, "stream", ("lb_keogh_stream", "lb_improved_pass2"),
                     "stream ops")


# ------------------------------------------------------------- phase 5


def phase_tuned(dev, launches, main):
    """The tuned session on phase 3's rows, against the untuned one."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import Database
    from repro_torch.kernels.tuning import TuneTable, active_table, install, use_table

    x, queries, untuned, base = main["x"], main["queries"], main["db"], main["res"]

    def same(a, b, what):
        if not (np.array_equal(a.indices, b.indices)
                and np.array_equal(a.distances, b.distances)):
            fail(f"{what}: answers differ from the untuned session's")

    def untuned_kim():
        t0 = time.perf_counter()
        res = untuned.search(queries, method="kim_improved")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # kim_improved at p = 1 runs the device loop: K6's feature phase once,
    # then per block K4 with LB_Kim as its entry and K5 with the merge; no
    # K6 launch, no synchronisation in the loop
    kim0, kim_s = counted(launches, "untuned_kim", untuned_kim)
    got = launches["untuned_kim"]
    require_launched(launches, "untuned_kim", ("lb_kim_features", "lb_fused", "dtw_merge"),
                     "untuned kim_improved search")
    s0 = kim0.stats
    others = {name: got[name] for name in ("lb_kim", "dtw", "block_merge", "lb_keogh",
                                           "lb_improved_pass2", "lb_keogh_stream")}
    if (got["lb_fused"], got["dtw_merge"]) != (s0.blocks_total,) * 2 or any(
            others.values()) or got["lb_kim_features"] != 1:
        fail(f"untuned kim_improved: expected one feature launch, then two launches per "
             f"block ({s0.blocks_total} blocks), one lb_fused and one dtw_merge, and no "
             f"lb_kim, dtw or standalone merge launch, got {got}")
    same(kim0, base, "untuned kim_improved")
    if s0.full_dtw > base.stats.full_dtw:
        fail(f"untuned kim_improved: survivors {s0.full_dtw} are no subset of the default "
             f"session's {base.stats.full_dtw}")
    enqueue_s, loop_s = loop_without_sync(dev, untuned, queries, kim0, kim=True)
    log(f"[tuned] untuned kim_improved: {kim_s:.3f} s = {N_QUERIES / kim_s:.2f} qps; pruned "
        f"{s0.pruned_by}, full_dtw {s0.full_dtw} (default {base.stats.full_dtw}); answers == "
        f"the default session's; the loop under set_sync_debug_mode('error') {loop_s:.3f} s "
        f"({enqueue_s / s0.blocks_total * 1e6:.1f} us a block to enqueue), same answers and "
        f"counters; launches {got}")

    def untuned_kim_webb():
        t0 = time.perf_counter()
        res = untuned.search(queries, method="kim_webb")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # kim_webb keeps the host loop: per block K6 alone, then K2 and LB_Webb
    # on the lanes LB_Kim left, and the survivors' DP on pair lists.  Each
    # block meets the same k-th best as in kim_improved's loop (both answer
    # exactly over the rows before it), so LB_Kim and LB_Keogh prune the
    # same lanes there as K4's entry did
    webb, webb_s = counted(launches, "untuned_kim_webb", untuned_kim_webb)
    got = launches["untuned_kim_webb"]
    require_launched(launches, "untuned_kim_webb", ("lb_kim", "lb_keogh", "dtw"),
                     "untuned kim_webb search")
    sw = webb.stats
    if got["lb_kim"] != sw.blocks_total or any(
            got[name] for name in ("lb_kim_features", "lb_fused", "dtw_merge")):
        fail(f"untuned kim_webb: expected the host loop, one lb_kim launch per block "
             f"({sw.blocks_total} blocks) and no lb_kim_features, lb_fused or dtw_merge "
             f"launch, got {got}")
    same(webb, base, "untuned kim_webb")
    if (tuple(sw.stage_pruned[:2]) != tuple(s0.stage_pruned[:2])
            or sw.blocks_lb2 != s0.blocks_lb2):
        fail(f"untuned kim_webb: LB_Kim and LB_Keogh pruned {sw.stage_pruned[:2]} "
             f"(blocks_lb2 {sw.blocks_lb2}) on the host loop against "
             f"{s0.stage_pruned[:2]} ({s0.blocks_lb2}) in kim_improved's device loop")
    log(f"[tuned] untuned kim_webb (host loop): {webb_s:.3f} s = {N_QUERIES / webb_s:.2f} "
        f"qps; pruned {sw.pruned_by}, full_dtw {sw.full_dtw}; LB_Kim and LB_Keogh pruned as "
        f"in kim_improved's loop; answers == the default session's; launches {got}")

    with use_table(TuneTable.with_defaults()):
        def tuned():
            t0 = time.perf_counter()
            db = Database.build(x, tune=dict(verbose=True))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                path = db.save(f"{tmp}/tuned")
                with np.load(path) as z:
                    keys = sorted(k for k in z.files if k.startswith("tune_"))
                install(TuneTable(), merge=False)  # load must install it again
                loaded = Database.load(path)
                io_s = time.perf_counter() - t0
            if keys != ["tune_json", "tune_version"]:
                fail(f"tuned bundle keys {keys}")
            if loaded.tune_table.to_json() != db.tune_table.to_json():
                fail("the tune table did not survive save/load")
            for key, cfg in db.tune_table.entries.items():
                if active_table().entries.get(key) != cfg:
                    fail(f"load did not install the tuned entry {key}")
            t0 = time.perf_counter()
            auto = loaded.search(queries, method="auto")
            torch.cuda.synchronize()
            auto_s = time.perf_counter() - t0
            kim = loaded.search(queries, method="kim_improved")
            torch.cuda.synchronize()
            return db, loaded, auto, kim, build_s, io_s, auto_s

        db, loaded, auto, kim, build_s, io_s, auto_s = counted(launches, "tuned", tuned)
        require_launched(launches, "tuned", ("envelope", "lb_kim", "lb_keogh",
                                             "lb_improved_pass2", "lb_fused", "dtw"),
                         "tuned session")
        same(auto, base, "tuned method='auto'")
        same(kim, kim0, "tuned kim_improved")
        explain = loaded.plan(queries, method="auto").explain()
        if "unit costs: measured by the kernel tune sweep" not in explain:
            fail(f"plan().explain() shows no measured costs:\n{explain}")
        log(f"[tuned] build with tune {build_s:.2f} s; save + load {io_s:.1f} s; "
            f"tune table {db.tune_table.to_json()}")
        log("[tuned] auto plan: " + " | ".join(explain.splitlines()))
        log(f"[tuned] method=auto search {auto_s:.2f} s = {N_QUERIES / auto_s:.2f} qps; "
            f"answers == untuned; kim_improved answers == untuned; launches "
            f"{launches['tuned']}")
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.tune", "--length", str(LENGTH),
             "--block", str(BLOCK)],
            capture_output=True, text=True, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            timeout=300,
        )
        if cli.returncode != 0:
            fail(f"python -m repro_torch.launch.tune failed:\n{cli.stdout}\n{cli.stderr}")
        tail = [ln for ln in cli.stdout.splitlines() if ln.startswith(("#", "    ("))]
        log("[tuned] launch.tune: " + " | ".join(tail[-12:]))
    if active_table().entries != TuneTable.with_defaults().entries:
        fail("the default tune table was not restored")


# ------------------------------------------------------------- phase 6

#: references of the indexed session (the CLI's --n-refs default)
N_REFS = 16


def start_python(args: list[str]) -> subprocess.Popen:
    """``python <args>`` from the repository root, started, its output piped."""
    return subprocess.Popen(
        [sys.executable, *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )


def finish_python(proc: subprocess.Popen, what: str, timeout: float = 300) -> str:
    """Wait for a process of ``start_python``; its stdout, or a failure."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{what}: no exit within {timeout} s")
    if proc.returncode != 0:
        fail(f"{what}: exit {proc.returncode}\n{out}\n{err}")
    return out


def cli_rows(out: str, what: str):
    """The search CLI's per-query (nn, line) pairs, each line required to
    parse."""
    import re

    lines = [ln for ln in out.splitlines() if ln.startswith("query ")]
    rows = []
    for ln in lines:
        m = re.match(r"query (\d+): nn=(\d+) dist=([0-9.]+) .*dtw=(\d+)", ln)
        if not m:
            fail(f"{what}: unparsable line {ln!r}")
        rows.append(int(m.group(2)))
    return rows, lines


def phase_indexed(dev, launches, main):
    """The indexed session (stage 0 through the triangle index) on phase
    3's rows at p = inf and p = 1, gated on exactness."""
    import numpy as np
    import torch

    from repro_torch.api import Database, SearchConfig
    from repro_torch.index import build_index
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.dtw.ops import dtw_qbatch_op

    x, queries = main["x"], main["queries"]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for p in (math.inf, 1):
        tag = f"[index p={p}]"
        cfg = SearchConfig(p=p)
        before = {ph: dict(c) for ph, c in launches.items()}
        lap(f"6 p={p} build")
        db, build_s = counted(launches, "index build", lambda: timed(
            lambda: Database.build(x, cfg, index=True, n_refs=N_REFS)))
        # the index alone, built again from the session's rows: its time and
        # its K5 launches (not counted in a phase), and the same references
        reset_launch_counts()
        lap(f"6 p={p} index again")
        again, index_s = timed(lambda: build_index(db.rows_tensor, db.w, p, n_refs=N_REFS))
        index_k5 = launch_counts()["dtw"]
        reset_launch_counts()
        if not np.array_equal(again.ref_idx, db.index.ref_idx):
            fail(f"{tag} a second build chose other references")
        plan = db.plan(queries).explain()
        if not plan.startswith("driver: indexed"):
            fail(f"{tag} the indexed session did not route to the indexed driver:\n{plan}")
        lap(f"6 p={p} search")
        res, search_s = counted(launches, "indexed search", lambda: timed(
            lambda: db.search(queries)))
        lap(f"6 p={p} checks")
        s = res.stats
        got = {ph: {k: v - before.get(ph, {}).get(k, 0) for k, v in c.items() if v}
               for ph, c in launches.items() if ph in ("index build", "indexed search")}
        log(f"{tag} {db!r}: build {build_s:.2f} s (the index alone {index_s:.2f} s, "
            f"{index_k5} K5 launches; the session {build_s - index_s:.2f} s); "
            f"theorem 1 constant {db.index.constant:.4g}")
        log(f"{tag} plan: " + " | ".join(plan.splitlines()[:2]))
        log(f"{tag} search of {len(queries)} queries {search_s:.3f} s = "
            f"{len(queries) / search_s:.2f} qps; stage 0 pruned {s.lb0_pruned} of "
            f"{s.n_candidates} ({100 * s.stage0_ratio:.2f}%), clusters {s.clusters_pruned} "
            f"of {s.clusters_total}; pruned {s.pruned_by}, full_dtw {s.full_dtw}; blocks "
            f"{s.blocks_total} (of them with pass 2 {s.blocks_lb2}, with the DP "
            f"{s.blocks_dtw}), DP lanes {s.dp_lane_useful}/{s.dp_lane_work}")
        log(f"{tag} launches: {got}")
        require_launched(launches, "index build", ("dtw",), f"{tag} index build")
        require_launched(launches, "indexed search",
                         ("envelope", "lb_keogh", "lb_improved_pass2", "dtw"),
                         f"{tag} indexed search")
        for phase, names in (("index build", ("dtw",)),
                             ("indexed search", ("envelope", "lb_keogh", "lb_improved_pass2",
                                                 "dtw"))):
            for name in names:
                if got[phase].get(name, 0) <= 0:
                    fail(f"{tag} {phase} launched no {name}: {got}")
        if s.lb0_pruned + sum(s.stage_pruned) + s.full_dtw != s.n_candidates:
            fail(f"{tag} counts do not add up to the candidates: {s}")

        # exactness: two queries' top-1 against a K5 brute force over every row
        qs = torch.as_tensor(db.prepare_queries(queries[:2]), device=dev)
        best = dtw_qbatch_op(qs, db.rows_tensor, db.w, p).argmin(dim=1).cpu().numpy()
        if not np.array_equal(best, res.indices[:2, 0]):
            fail(f"{tag} top-1 {res.indices[:2, 0]} != brute force {best}")
        # and every answer against an unindexed session at the same p
        lap(f"6 p={p} unindexed session")
        if p == 1:
            plain, plain_s, route = main["res"], main["search_s"], "host driver, device loop"
        else:
            plain_db = Database.build(x, cfg)
            route = f"{plain_db.plan(queries).driver} driver, host loop"
            plain, plain_s = timed(lambda: plain_db.search(queries))
            del plain_db
        if not np.array_equal(res.indices, plain.indices):
            fail(f"{tag} indices differ from the unindexed session's")
        if np.array_equal(res.distances, plain.distances):
            same = "the same distance bits"
        else:
            err = float(np.max(np.abs(res.distances - plain.distances) / plain.distances))
            if err > 2e-4:
                fail(f"{tag} distances differ from the unindexed session's by {err:.3g}")
            same = f"distances within rtol {err:.3g} (not bit-equal)"
        log(f"{tag} brute force top-1 {best.tolist()} == indexed top-1; the unindexed "
            f"session ({route}, {plain_s:.3f} s = {len(queries) / plain_s:.2f} qps): the "
            f"same indices, {same}")
        del db, again, res


def phase_cli():
    """``python -m repro_torch.launch.search`` and the quickstart twin as
    subprocesses on the card, run side by side."""
    import numpy as np

    from repro_torch.api import Database, SearchConfig
    from repro_torch.data.synthetic import random_walks

    # the search CLI, with the index at p = inf and with its defaults, each
    # query's nn against a direct db.search of the same rows and queries
    runs = ((["--index", "--p", "inf", "--n-refs", str(N_REFS)], SearchConfig(p=math.inf),
             True), ([], SearchConfig(), False))
    t0 = time.perf_counter()
    procs = [start_python(["-m", "repro_torch.launch.search", *args]) for args, _, _ in runs]
    quick = start_python(["examples/quickstart_torch.py"])
    try:
        for (args, cfg, index), proc in zip(runs, procs):
            what = f"launch.search {' '.join(args)}"
            lap(f"6 direct session of {' '.join(args) or '(defaults)'}")
            rng = np.random.default_rng(0)  # the CLI's --seed default
            data = random_walks(rng, 4096, 512)  # its --db-size, --length
            qs = random_walks(rng, 4, 512)  # its --queries
            direct = Database.build(data, cfg, index=index, n_refs=N_REFS).search(qs)
            lap(f"6 CLI {' '.join(args) or '(defaults)'}")
            out = finish_python(proc, what)
            cli_s = time.perf_counter() - t0
            check_cli(args, index, out, direct, cli_s)
        lap("6 quickstart")
        out = finish_python(quick, "examples/quickstart_torch.py")
    finally:
        for proc in (*procs, quick):
            proc.kill()
            proc.communicate()
    head = [ln for ln in out.splitlines() if ln.startswith(("lb_improved", "batched"))]
    log(f"[index cli] examples/quickstart_torch.py (2,000 x 512): exit 0 in "
        f"{time.perf_counter() - t0:.1f} s (beside the two CLI runs); " + " | ".join(head))


def check_cli(args, index, out, direct, cli_s):
    """One search CLI run's lines against a direct ``db.search``."""
    nn, lines = cli_rows(out, f"launch.search {' '.join(args)}")
    if nn != direct.indices[:, 0].tolist():
        fail(f"launch.search {args}: nn {nn} != direct db.search {direct.indices[:, 0]}")
    served = [ln for ln in out.splitlines() if ln.startswith(("served", "mesh="))]
    if not index and ("mesh={'data': 1, 'model': 1}" not in out.splitlines()
                      or "driver: sharded" not in out):
        fail(f"launch.search (defaults) did not serve through the one-rank mesh:\n{out}")
    log(f"[index cli] launch.search {' '.join(args) or '(defaults)'}: exit 0 in "
        f"{cli_s:.1f} s (side by side), nn {nn} == direct db.search; {lines[0]} | "
        f"{' | '.join(served)}")


# ------------------------------------------------------------- phase 7

#: the stream session: samples (about 2.9 h of a 100 Hz signal), push
#: chunk, hop, planted occurrences, template length; the calibration head
STREAM_SESSION = (1_048_576, 4096, 4, 512, 128)
STREAM_HEAD = 4096
#: windows per K5 launch of the stream's brute force
BRUTE_CHUNK = 65_536
#: the motion-segmentation example's samples
MOTION_SAMPLES = 6000


def stream_brute_force(dev, stream, templates, w, p, hop, znorm, thr, exclusion):
    """Every window against every template through K5 on the card (chunks
    of BRUTE_CHUNK windows), then the threshold and ``greedy_suppress``:
    the matches a scan without bounds gives.  The first chunk's K5 output
    is held against ``dtw_wavefront_plain`` (bit-equal) and ``dtw_plain``
    (rtol 3e-4)."""
    import numpy as np
    import torch

    from repro_torch.kernels.dtw.ops import dtw_plain, dtw_qbatch_op, dtw_wavefront_plain
    from repro_torch.stream import (
        Match,
        greedy_suppress,
        prefix_sums,
        window_mean_std_from_prefix,
        znorm_series,
        znorm_windows,
    )
    from repro_torch.stream.subsequence import finish_np, powered_threshold

    n = templates.shape[1]
    starts = np.arange(0, stream.size - n + 1, hop)
    qs = np.stack([znorm_series(t) for t in templates]) if znorm else templates
    qs_t = torch.as_tensor(qs, device=dev)
    sw = np.lib.stride_tricks.sliding_window_view(stream, n)[::hop]
    c1 = c2 = None
    if znorm:
        c1, c2 = prefix_sums(stream)
    thr_pow = powered_threshold(thr, p)
    hits = []
    for lo in range(0, starts.size, BRUTE_CHUNK):
        st = starts[lo : lo + BRUTE_CHUNK]
        wins = sw[lo : lo + BRUTE_CHUNK]
        if znorm:
            wins = znorm_windows(wins, *window_mean_std_from_prefix(c1, c2, st, n))
        wins_t = torch.as_tensor(np.ascontiguousarray(wins), device=dev)
        d_t = dtw_qbatch_op(qs_t, wins_t, w, p)
        if lo == 0:  # K5 at this session's shapes against its plain versions
            what = f"brute force chunk Q={qs_t.shape[0]} B={wins_t.shape[0]} n={n} w={w} p={p}"
            check_equal("dtw", d_t, dtw_wavefront_plain(qs_t, wins_t, w, p),
                        f"{what} vs wavefront plain")
            check_close("dtw", d_t, dtw_plain(qs_t, wins_t, w, p), TOL["dtw"],
                        f"{what} vs dtw_plain")
        d = d_t.cpu().numpy()
        hit = d <= thr_pow[:, None]
        rooted = finish_np(d.astype(np.float64), p)
        hits += [Match(int(q), int(st[b]), float(rooted[q, b])) for q, b in zip(*np.nonzero(hit))]
    return greedy_suppress(hits, exclusion), len(hits)


@contextlib.contextmanager
def captured_blocks(keep_first: int = 2, keep_dtw: int = 2):
    """Keep a few of the blocks the stream scanners run while the context
    is open: the first ``keep_first``, the first ``keep_dtw`` whose DP ran
    and the last one (a flushed tail), each with its window tile, its S0
    mask and, where K7 ran, the flat segment it read and the values the
    stages took from it.  Yields the list, filled when the context ends."""
    from repro_torch.stream import subsequence as sub

    stages, k7 = sub.run_block_stages, sub.lb_keogh_stream_qbatch_op
    segs = {}  # thread -> the segment of K7's latest launch
    kept, last, seen = [], [], [0, 0]  # seen: blocks, kept blocks whose DP ran
    lock = threading.Lock()

    def k7_op(seg, *a, **kw):
        segs[threading.get_ident()] = seg
        return k7(seg, *a, **kw)

    def run_stages(*a, first=None, **kw):
        res = stages(*a, first=first, **kw)
        blk = dict(blk=a[6], mask0=a[8], first=first,
                   seg=segs.pop(threading.get_ident(), None) if first is not None else None)
        with lock:
            blk["index"] = seen[0]
            seen[0] += 1
            if blk["index"] < keep_first:
                kept.append(blk)
            elif res.need_dtw and seen[1] < keep_dtw:
                seen[1] += 1
                kept.append(blk)
            else:
                last[:] = [blk]
        return res

    sub.run_block_stages, sub.lb_keogh_stream_qbatch_op = run_stages, k7_op
    try:
        yield kept
    finally:
        sub.run_block_stages, sub.lb_keogh_stream_qbatch_op = stages, k7
        kept += last


def check_stream_blocks(tag, scanner, blocks):
    """A stream session's kernels held against their plain versions on
    blocks the session ran, at its own shapes and channel count d: K7 (K7c
    at d > 1) on the block's (d, span) segment (lb rtol 1e-4, H bit-equal;
    bit-equal to K2 on the tile and to the values the stages used), K2
    dense and on the S0 survivors' pairs, K3 (rtol 2e-4; at d > 1 over the
    channel segments folded into its rows, as the stages launch it) on
    both, and K5 (its channel entry at d > 1) dense (bit-equal to
    ``dtw_wavefront_plain``, rtol 3e-4 to ``dtw_plain``) and on the
    survivors' pairs with the gate as each lane's bound (bit-equal)."""
    import torch

    from repro_torch.kernels.dtw.ops import dtw_launch, dtw_plain, dtw_wavefront_plain
    from repro_torch.kernels.lb_improved.ops import (
        _folded_qidx,
        lb_improved_pass2_launch,
        lb_improved_pass2_plain,
    )
    from repro_torch.kernels.lb_keogh.ops import (
        lb_keogh_launch,
        lb_keogh_plain,
        lb_keogh_stream_launch,
        lb_keogh_stream_plain,
    )

    sc = scanner
    qs, upper, lower, w, p, n, hop = sc._qs, sc._upper, sc._lower, sc.w, sc.p, sc.n, sc.hop
    d, gate = sc.d, sc._gate
    k7, k5 = ("lb_keogh_stream_mv", "dtw_mv") if d > 1 else ("lb_keogh_stream", "dtw")
    nq = qs.shape[0]

    def check_k3(h, qidx, what):
        """K3 on H as the stages launch it: dense at d = 1, else over the
        (rows*d, n) channel segments with each row's folded query index."""
        if d == 1:
            args = (h, qs, w, p) if qidx is None else (h, qs, w, p, qidx)
        else:
            ch = torch.arange(d, device=h.device)
            qi = (_folded_qidx(nq, h.shape[1], d, h.device) if qidx is None
                  else (qidx[:, None] * d + ch).reshape(-1))
            args = (h.reshape(-1, n), qs.reshape(nq * d, n), w, p, qi)
        check_close("lb_improved_pass2", lb_improved_pass2_launch(*args),
                    lb_improved_pass2_plain(*args), TOL["lb_improved_pass2"], what)

    if not blocks:
        fail(f"{tag} no block was captured")
    for b in blocks:
        blk = b["blk"]
        what = (f"{tag} block {b['index']} (Q={nq} B={blk.shape[0]} n={n} d={d} "
                f"hop={hop} w={w} p={p})")
        lb, h = lb_keogh_launch(blk, upper, lower, p)
        lbp, hp = lb_keogh_plain(blk, upper, lower, p)
        check_close("lb_keogh", lb, lbp, TOL["lb_keogh"], what)
        check_close("lb_keogh", h, hp, 0.0, f"{what} H")
        if sc.stream_first:
            if b["seg"] is None:
                fail(f"{what}: S1 did not come from {k7}")
            slb, sh = lb_keogh_stream_launch(b["seg"], upper, lower, n, hop, p, d=d)
            plb, ph = lb_keogh_stream_plain(b["seg"], upper, lower, n, hop, p, d=d)
            check_close(k7, slb, plb, TOL[k7], what)
            check_equal(k7, sh, ph, f"{what} H")
            check_equal(k7, (slb, sh), (lb, h), f"{what} vs K2 on the tile")
            check_equal(k7, b["first"], slb, f"{what} vs the stages' S1")
        elif b["seg"] is not None:
            fail(f"{what}: {k7} ran where S1 is K2's")
        check_k3(h, None, what)
        dd = dtw_launch(qs, blk, w, p, d=d)
        check_equal(k5, dd, dtw_wavefront_plain(qs, blk, w, p, d=d),
                    f"{what} vs wavefront plain")
        check_close(k5, dd, dtw_plain(qs, blk, w, p, d=d), TOL["dtw"], f"{what} vs dtw_plain")
        qi, ci = b["mask0"].nonzero(as_tuple=True)
        if qi.numel():
            what = f"{what}, {qi.numel()} S0 survivors"
            lb, h = lb_keogh_launch(blk, upper, lower, p, qi, ci)
            lbp, hp = lb_keogh_plain(blk, upper, lower, p, qi, ci)
            check_close("lb_keogh", lb, lbp, TOL["lb_keogh"], f"{what} pairs")
            check_close("lb_keogh", h, hp, 0.0, f"{what} pairs H")
            check_k3(h, qi, f"{what} pairs")
            bounds = gate[qi].contiguous()
            check_equal(k5, dtw_launch(qs, blk, w, p, qi, ci, bounds, d=d),
                        dtw_wavefront_plain(qs, blk, w, p, qi, ci, bounds, d=d),
                        f"{what} pairs with the gate as bound")
    k7_name = "K7c" if d > 1 else "K7"
    log(f"{tag} {len(blocks)} of the session's blocks (Q={nq} B={sc.block} n={n} d={d} "
        f"hop={hop} w={w} p={p}): "
        + (f"{k7_name} == plain == K2 on the tile == the stages' S1; " if sc.stream_first
           else "")
        + ("K2, K3 and K5" if d == 1 else "K2, the folded K3 and K5's channel entry")
        + ", dense and on the S0 survivors' pairs, == their plain versions")


def subnormal_envelope_check(dev):
    """StreamState's online envelope of rows that hold float32 subnormals
    equals K1's on the card, bit for bit (the port keeps subnormals)."""
    import numpy as np
    import torch

    from repro_torch.kernels.envelope.ops import envelope_op
    from repro_torch.stream import StreamState

    rng = np.random.default_rng(SEED + 9)
    mixed = rng.standard_normal(1000).astype(np.float32)
    mixed[::3] *= np.float32(1e-39)  # every third value a subnormal
    rows = [(np.array([0.0, 1.0118855e-38], np.float32), 1), (mixed, 12), (mixed, 100)]
    for xs, w in rows:
        st = StreamState(len(xs) + 2 * w + 2, w)
        st.push(xs)
        u, l = st.envelope_view(0, len(xs))
        ku, kl = envelope_op(torch.as_tensor(xs, device=dev)[None].contiguous(), w)
        if not (np.array_equal(u, ku[0].cpu().numpy())
                and np.array_equal(l, kl[0].cpu().numpy())):
            fail(f"online envelope != K1 on a row with subnormals (n={len(xs)}, w={w})")
    subs = int(np.sum((mixed != 0) & (np.abs(mixed) < np.finfo(np.float32).tiny)))
    log(f"[stream] subnormals kept: StreamState's online envelope == K1 on the card, bit "
        f"for bit, on [0, 1.0118855e-38] (w=1) and on 1,000 values with {subs} "
        f"subnormals (w=12, 100)")


def phase_stream_session(dev, launches):
    """The stream session: ``db.stream`` over a template bank, a planted
    stream pushed in chunks and polled, znorm off (S1 by K7 over each
    block's flat segment) and on (S1 by K2 on the copied tile); each run
    against the offline ``windowed_matches`` and a K5 brute force."""
    import dataclasses
    import importlib.util

    import numpy as np
    import torch

    from repro_torch.api import Database, SearchConfig
    from repro_torch.core import pipeline
    from repro_torch.data.synthetic import planted_stream, template_bank
    from repro_torch.launch.stream import calibrate_thresholds
    from repro_torch.stream import windowed_matches

    t_phase = time.perf_counter()
    n_samples, chunk, hop, n_plants, n = STREAM_SESSION
    templates = template_bank(n, kinds=("sine", "cosine", "gaussian", "gaussian_inverted"))
    rng = np.random.default_rng(SEED + 7)
    stream, plants = planted_stream(rng, n_samples, templates, n_plants, noise_level=0.05)
    base = SearchConfig(w=12, p=2, block=64, method="lb_improved")

    # S1's dense stage, counted: the tile's LB_Keogh (K2's dense entry)
    dense_calls = [0]
    keogh = pipeline.STAGES["lb_keogh"]

    def counting_dense(ctx, blk):
        dense_calls[0] += 1
        return keogh.dense(ctx, blk)

    pipeline.STAGES["lb_keogh"] = dataclasses.replace(keogh, dense=counting_dense)
    try:
        for znorm in (False, True):
            tag = f"[stream znorm={znorm}]"
            db = Database.build(templates, dataclasses.replace(base, znorm=znorm))
            thr = calibrate_thresholds(templates, stream[:STREAM_HEAD], db.w, base.p, hop,
                                       znorm)
            dense_calls[0] = 0
            before = dict(launches.get("stream session", {}))

            def run():
                t0 = time.perf_counter()
                m = db.stream(threshold=thr, hop=hop)
                polled = []
                for lo in range(0, n_samples, chunk):
                    m.push(stream[lo : lo + chunk])
                    polled += m.poll()
                m.flush()
                polled += m.poll()
                torch.cuda.synchronize()
                return m, polled, time.perf_counter() - t0

            with captured_blocks() as sample:
                m, polled, run_s = counted(launches, "stream session", run)
            got = {k: v - before.get(k, 0) for k, v in launches["stream session"].items()}
            s = m.stats
            blocks, s1_dense = s.blocks_total, dense_calls[0]
            hits = m.matches()
            if sorted(polled, key=lambda h: (h.start, h.tid)) != hits:
                fail(f"{tag} the polled matches differ from matches()")
            if not np.array_equal(s.env_pruned + s.stage_pruned.sum(axis=0) + s.full_dtw,
                                  s.n_windows):
                fail(f"{tag} env + stages + dtw != windows: {s}")
            # the launches: K7 once a block without znorm, else K2's dense S1
            want_k7, want_dense = (0, blocks) if znorm else (blocks, 0)
            if (got["lb_keogh_stream"], s1_dense) != (want_k7, want_dense):
                fail(f"{tag} S1: {got['lb_keogh_stream']} K7 launches and {s1_dense} dense "
                     f"K2 stages in {blocks} blocks, expected {want_k7} and {want_dense}")
            # the offline replay and a K5 brute force over every window
            t0 = time.perf_counter()
            offline, _ = counted(launches, "stream offline", lambda: windowed_matches(
                stream, templates, db.w, thr, p=base.p, hop=hop, znorm=znorm,
                block=base.block, device=dev))
            offline_s = time.perf_counter() - t0
            if offline != hits:
                fail(f"{tag} streamed matches != offline windowed_matches")
            t0 = time.perf_counter()
            brute, raw_hits = stream_brute_force(dev, stream, templates, db.w, base.p, hop,
                                                 znorm, thr, m.exclusion)
            brute_s = time.perf_counter() - t0
            if [(h.tid, h.start) for h in brute] != [(h.tid, h.start) for h in hits]:
                fail(f"{tag} matches != the K5 brute force's")
            if [h.dist for h in brute] != [h.dist for h in hits]:
                fail(f"{tag} match distances are not the K5 brute force's bits")
            tol = max(hop, n // 16)
            recovered = sum(any(h.tid == tid and abs(h.start - pos) <= tol for h in hits)
                            for tid, pos, _ in plants)
            windows = int(s.n_windows[0])
            log(f"{tag} {n_samples:,} samples in {chunk}-sample chunks, {windows:,} windows "
                f"x {s.n_templates} templates in {blocks} blocks: {run_s:.2f} s = "
                f"{n_samples / run_s:,.0f} samples/s; thresholds {np.round(thr, 4).tolist()}")
            log(f"{tag} matches {len(hits)} (raw hits {int(s.matched.sum())}), planted "
                f"recovered {recovered}/{len(plants)}; pruned S0 {int(s.env_pruned.sum()):,}, "
                + ", ".join(f"{k} {int(v.sum()):,}" for k, v in s.pruned_by.items())
                + f", dtw {int(s.full_dtw.sum()):,} of {int(s.n_windows.sum()):,} lanes; "
                f"blocks with pass 2 {s.blocks_lb2}, with the DP {s.blocks_dtw}; DP lanes "
                f"{s.dp_lane_useful}/{s.dp_lane_work}")
            log(f"{tag} launches: { {k: v for k, v in got.items() if v} }; S1 dense stages "
                f"{s1_dense}")
            log(f"{tag} == offline windowed_matches ({offline_s:.2f} s) == K5 brute force "
                f"({brute_s:.2f} s, {raw_hits} raw hits): same (tid, start) and distance bits")
            check_stream_blocks(tag, m.scanner, sample)
            if not znorm:
                stream_breakdown(dev, db, thr, stream, hop, chunk, tag)
            del db, m
    finally:
        pipeline.STAGES["lb_keogh"] = keogh
    subnormal_envelope_check(dev)

    # the motion-segmentation example at its full size, in this process
    path = ROOT / "examples" / "motion_segmentation_torch.py"
    spec = importlib.util.spec_from_file_location("motion_segmentation_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    segments, ms = counted(launches, "stream example", lambda: example.main(MOTION_SAMPLES))
    log(f"[stream] examples/motion_segmentation_torch.py ({MOTION_SAMPLES:,} samples): "
        f"{len(segments)} segments, {ms.blocks_total} blocks, in "
        f"{time.perf_counter() - t0:.2f} s; launches "
        f"{ {k: v for k, v in launches['stream example'].items() if v} }")
    log(f"[stream] phase 7 took {time.perf_counter() - t_phase:.1f} s")


def stream_breakdown(dev, db, thr, stream, hop, chunk, tag):
    """Where a stream session's time goes, on a quarter of the stream: the
    host's pushes into StreamState alone, the lanes and S0 on the host
    (``_window_lanes``), the rest of each block (uploads, the stages with
    their synchronising reads, the copy back), and the device's busy time
    by kernel from one profiled run (CUDA activity only)."""
    import torch

    from repro_torch.stream import StreamState

    part = stream[: stream.size // 4]
    st = StreamState(2 * ((db.config.block - 1) * hop + db.length), db.w)
    t0 = time.perf_counter()
    for lo in range(0, part.size, chunk):
        st.push(part[lo : lo + chunk])
    push_s = time.perf_counter() - t0

    m = db.stream(threshold=thr, hop=hop)
    sc = m.scanner
    spent = {"lanes": 0.0, "block": 0.0}
    lanes_fn, block_fn = sc._window_lanes, sc.process_block

    def timed_lanes(*a):
        t = time.perf_counter()
        out = lanes_fn(*a)
        spent["lanes"] += time.perf_counter() - t
        return out

    def timed_block(*a):
        t = time.perf_counter()
        out = block_fn(*a)
        spent["block"] += time.perf_counter() - t
        return out

    sc._window_lanes, sc.process_block = timed_lanes, timed_block
    wall = []

    def run():
        t = time.perf_counter()
        for lo in range(0, part.size, chunk):
            m.push(part[lo : lo + chunk])
            m.poll()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)

    run()  # timed, unprofiled
    blocks = m.stats.blocks_total
    total_s = wall[-1]
    lanes_s, block_s = spent["lanes"], spent["block"]
    log(f"{tag} breakdown over {part.size:,} samples ({blocks} blocks): wall "
        f"{total_s:.3f} s; pushes into StreamState alone {push_s:.3f} s "
        f"({push_s / part.size * 1e6:.2f} us a sample); per block: lanes and S0 on the "
        f"host {lanes_s / blocks * 1e3:.3f} ms, uploads + stages + syncs + copy back "
        f"{(block_s - lanes_s) / blocks * 1e3:.3f} ms; the rest (pushes, exclusion) "
        f"{(total_s - block_s) / blocks * 1e3:.3f} ms")
    m = db.stream(threshold=thr, hop=hop)
    got = profiled_kernels(run, "profiled stream session")
    if got:
        busy = sum(us for us, _ in got.values()) / 1e3
        top = sorted(got.items(), key=lambda kv: -kv[1][0])[:8]
        log(f"{tag} profiled run: device busy {busy:.1f} ms of {wall[-1] * 1e3:.1f} ms wall "
            f"= idle share {1 - busy / (wall[-1] * 1e3):.3f}; device ms by kernel: "
            + "; ".join(f"{k[:40]} {us / 1e3:.2f} ms / {c}" for k, (us, c) in top))
    else:
        log(f"{tag} profiled run: the profiler saw no device time; idle share not measured")


# ------------------------------------------------------------- phase 8

#: the serve phase: requests, client threads, max_batch; the concurrent
#: stream session's templates (rows), hop and samples
SERVE = (64, 4, 16)
SERVE_STREAM = (16, 16, 262_144)


def phase_serve(dev, launches, main):
    """A QueryEngine over phase 3's default session serving the serve
    CLI's mixed workload from client threads while a stream session runs
    beside it; every answer against a direct ``db.search``, the stream
    session's matches against a direct ``db.stream`` matcher's, and its
    kernels on a few of its blocks against their plain versions."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import random_walks
    from repro_torch.launch.serve import mixed_workload, replay
    from repro_torch.launch.stream import calibrate_thresholds
    from repro_torch.serve import QueryEngine

    t_phase = time.perf_counter()
    db, x = main["db"], main["x"]
    n_requests, n_clients, max_batch = SERVE
    n_templates, hop, n_samples = SERVE_STREAM
    rng = np.random.default_rng(SEED + 8)
    workload = mixed_workload(rng, x, n_requests, repeat_frac=0.3, near_frac=0.4)
    signal = random_walks(rng, 1, n_samples)[0]
    templates = x[:n_templates]
    thr = calibrate_thresholds(templates, signal[:STREAM_HEAD], db.w, db.p, hop, False,
                               device=dev)
    engine = QueryEngine(db, max_batch=max_batch)
    replay(engine, workload[:max_batch], 1)  # warm up the (max_batch, n) shape

    def run():
        sess = engine.open_stream(templates, threshold=thr, hop=hop)
        streamed, stream_s = [], []

        def stream_client():
            t0 = time.perf_counter()
            for lo in range(0, n_samples, 4096):
                streamed.extend(sess.feed(signal[lo : lo + 4096]))
            streamed.extend(sess.close())
            stream_s.append(time.perf_counter() - t0)

        client = threading.Thread(target=stream_client)
        t0 = time.perf_counter()
        client.start()
        served = replay(engine, workload, n_clients)
        queries_s = time.perf_counter() - t0
        client.join(timeout=600)
        if client.is_alive():
            fail("the stream session's client did not finish")
        torch.cuda.synchronize()
        return served, queries_s, sess, streamed, stream_s[0], time.perf_counter() - t0

    with captured_blocks() as sample:
        served, queries_s, sess, streamed, stream_s, wall_s = counted(launches, "serve", run)
    stats = engine.stats()
    engine.close()
    direct = db.search(workload)
    for qi, _, ans in served:
        if not (np.array_equal(ans.distances, direct.distances[qi])
                and np.array_equal(ans.indices, direct.indices[qi])):
            fail(f"[serve] request {qi}: the engine's answer is not a direct db.search's")
    ref = db.stream(templates, threshold=thr, hop=hop)
    ref.push(signal)
    ref.flush()
    if sorted(streamed, key=lambda h: (h.start, h.tid)) != ref.matches():
        fail("[serve] the stream session's matches differ from a direct db.stream matcher's")
    lat_ms = np.sort([1e3 * dt for _, dt, _ in served])
    log(f"[serve] {len(served)} requests from {n_clients} clients (max_batch {max_batch}) "
        f"in {queries_s:.3f} s = {len(served) / queries_s:.1f} qps; latency p50 "
        f"{np.percentile(lat_ms, 50):.2f} ms, p99 {np.percentile(lat_ms, 99):.2f} ms; "
        f"batches {stats.batches}, occupancy {stats.batch_occupancy:.2f}, coalesced "
        f"{stats.coalesced}, cache hit rate {stats.cache_hit_rate:.2f}")
    log(f"[serve] beside them a stream session ({n_templates} rows as templates, hop {hop}): "
        f"{n_samples:,} samples in {stream_s:.2f} s = {n_samples / stream_s:,.0f} samples/s, "
        f"{len(streamed)} matches, {sess.stats.blocks_total} blocks; wall {wall_s:.2f} s")
    log(f"[serve] every answer == a direct db.search of the workload (indices and distance "
        f"bits); the stream session's matches == a direct db.stream matcher's; launches "
        f"{ {k: v for k, v in launches['serve'].items() if v} }")
    require_launched(launches, "serve", ("envelope", "lb_fused", "dtw_merge",
                                         "lb_keogh_stream"), "serve")
    check_stream_blocks("[serve stream]", sess.matcher.scanner, sample)
    log(f"[serve] phase 8 took {time.perf_counter() - t_phase:.1f} s")


def run_module(args, what, timeout=600):
    """``python -m <module> <args>`` from the repository root; its stdout."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", *args], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=timeout,
    )
    if proc.returncode != 0:
        fail(f"{what}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout, time.perf_counter() - t0


def phase_stream_serve_cli():
    """The stream CLI at its defaults and with ``--znorm``, and the serve
    CLI with ``--stream-samples 4096``, as subprocesses: each exits 0 and
    prints the reference's lines."""
    for args, heads in (
        (["repro_torch.launch.stream"], ("stream=", "pruned before DTW", "matches=")),
        (["repro_torch.launch.stream", "--znorm"], ("stream=", "pruned before DTW",
                                                    "matches=")),
        (["repro_torch.launch.serve", "--stream-samples", "4096"],
         ("built session", "replayed", "latency", "engine:", "answers verified",
          "stream session:")),
    ):
        what = " ".join(args)
        out, secs = run_module(args, what)
        lines = out.splitlines()
        for head in heads:
            if not any(ln.startswith(head) for ln in lines):
                fail(f"{what}: no line starting with {head!r}:\n{out}")
        shown = [ln for ln in lines if ln.startswith(heads[1:])]
        log(f"[cli] {what}: exit 0 in {secs:.1f} s; " + " | ".join(shown))


# ------------------------------------------------------------- phase 9

#: the multivariate default session: the shape of UWaveGestureLibrary in
#: the UEA multivariate archive (Bagnall et al. 2018), a 3-axis
#: accelerometer gesture: rows, length n, channels d
MV_SESSION = (100_000, 315, 3)
#: the scan-route mv session (rows, length, channels) and its index's R
MV_SCAN = (768, 128, 3)
MV_SCAN_REFS = 8
#: K5's channel entry where d*n pushes a pair's rows past a block's
#: shared memory (its in-place path): (d, n, w), float32
MV_LONG = (8, 4000, 40)


def mv_walks(rng, rows: int, n: int, d: int):
    """(rows, n, d) float32 random walks, one per channel."""
    from repro_torch.data.synthetic import random_walks

    return random_walks(rng, rows * d, n).reshape(rows, d, n).swapaxes(1, 2)


def mv_block_checks(dev, db, qs, res, rec):
    """The mv session's kernels against their plain versions on the first
    two blocks and the tail block, at the session's shapes: K1 on the
    (B*d, n) segment view (bit-equal), K2 on the flat rows, the folded K3
    (2e-4), and K5's channel entry, pair list and masked with the merge,
    bit-equal to ``dtw_wavefront_plain(d=)`` / ``dtw_merge_plain(d=)``
    (block 0 against BIG, every slot live; the others against the
    search's final bounds).  Then K5's channel entry at p = 2 and inf, at
    d = 8, and on its in-place path.  Adds the channel entries' records."""
    import numpy as np
    import torch

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.common import BIG, KERNEL_DTYPES
    from repro_torch.kernels.dtw.ops import (
        dtw_launch,
        dtw_masked_prepare,
        dtw_merge_plain,
        dtw_plain,
        dtw_wavefront_plain,
    )
    from repro_torch.kernels.envelope.ops import envelope_launch, envelope_op, envelope_plain
    from repro_torch.kernels.lb_fused.ops import lb_fused_prepare
    from repro_torch.kernels.lb_improved.ops import (
        _folded_qidx,
        lb_improved_pass2_launch,
        lb_improved_pass2_plain,
        lb_improved_pass2_qbatch_op,
    )
    from repro_torch.kernels.lb_keogh.ops import lb_keogh_launch, lb_keogh_plain

    rows, w, d = db.rows_tensor, db.w, db.channels
    nq, total = qs.shape
    n, b = total // d, BLOCK
    n_rows = rows.shape[0]
    upper, lower = envelope_op(qs, w, d)
    final = torch.as_tensor(res.distances[:, -1], device=dev).contiguous()  # p = 1
    tail = (n_rows - 1) // b * b
    cells = n * (2 * w + 1) - w * (w + 1)
    lb2_err = 0.0
    for lo in (0, b, tail):
        cands = rows[lo : lo + b]
        real = cands.shape[0]
        if real < b:  # the loop pads the tail block with its last row
            cands = torch.cat([cands, cands[-1:].expand(b - real, total)]).contiguous()
        what = f"mv block at row {lo}"
        seg = cands.reshape(-1, n)
        u, l = envelope_launch(seg, w)
        check_equal("envelope", (u, l), envelope_plain(seg, w), f"{what}: K1 on (B*d, n)")
        lb1, h = lb_keogh_launch(cands, upper, lower, 1)
        lb1p, hp = lb_keogh_plain(cands, upper, lower, 1)
        check_close("lb_keogh", lb1, lb1p, TOL["lb_keogh"], f"{what}: flat rows")
        check_close("lb_keogh", h, hp, 0.0, f"{what}: flat H")
        hrows, qs_ch = h.reshape(-1, n), qs.reshape(-1, n)
        qi = _folded_qidx(nq, b, d, dev)
        lb2 = lb_improved_pass2_launch(hrows, qs_ch, w, 1, qi)
        e = check_close("lb_improved_pass2", lb2, lb_improved_pass2_plain(hrows, qs_ch, w, 1, qi),
                        TOL["lb_improved_pass2"], f"{what}: folded rows")
        lb2_err = max(lb2_err, e)
        bound = torch.full_like(final, BIG) if lo == 0 else final
        stage = torch.empty((nq, b), dtype=torch.uint8, device=dev)
        lb_fused_prepare(qs, upper, lower, w, bound, 1, b, stage, d=d)(cands, real)
        live = stage == 2
        pq, pc = (t.contiguous() for t in live.nonzero(as_tuple=True))
        if pq.numel():
            check_equal("dtw_mv", dtw_launch(qs, cands, w, 1, pq, pc, d=d),
                        dtw_wavefront_plain(qs, cands, w, 1, pq, pc, d=d),
                        f"{what}: {pq.numel()} live pairs")
        state = (torch.full((nq, 1), BIG, device=dev),
                 torch.full((nq, 1), -1, dtype=torch.int64, device=dev),
                 torch.zeros((3, nq), dtype=torch.int64, device=dev),
                 torch.zeros(4, dtype=torch.int64, device=dev))
        want = [t.clone() for t in state]
        out = torch.full((nq, b), math.nan, device=dev)
        out_w = out.clone()
        dtw_masked_prepare(qs, w, 1, stage, None, out, (*state, DTW_CHUNK), d=d)(cands, lo)
        dtw_merge_plain(qs, cands, stage, w, 1, None, out_w, *want, lo, DTW_CHUNK,
                        dp=dtw_wavefront_plain, d=d)
        check_equal("dtw_merge_mv", out[live], out_w[live], f"{what}: DP slots")
        check_equal("dtw_merge_mv", tuple(state), tuple(want), f"{what}: top-k and counters")
        log(f"[mv] {what}: K1, K2, folded K3, K5's channel entry (pairs and masked with "
            f"the merge, {int(live.sum())} live slots) match their plain versions")
    # the channel entry at p in {1, 2, inf}, d = 8 and on its in-place path
    rng = np.random.default_rng(SEED + 10)
    lib_slots = []
    for dd, nn, ww, npair in ((d, n, w, 16), (8, n, w, 16), (*MV_LONG, 2)):
        qv = torch.as_tensor(mv_walks(rng, 2, nn, dd).swapaxes(1, 2).reshape(2, -1),
                             device=dev).contiguous()
        cv = torch.as_tensor(mv_walks(rng, 8, nn, dd).swapaxes(1, 2).reshape(8, -1),
                             device=dev).contiguous()
        pi = torch.as_tensor(rng.integers(0, 2, npair), device=dev)
        pj = torch.as_tensor(rng.integers(0, 8, npair), device=dev)
        slots = cuda_lib.library().repro_dtw_slots(KERNEL_DTYPES[torch.float32], nn, ww, dd)
        lib_slots.append(slots)
        for p in (1, 2, math.inf):
            got = dtw_launch(qv, cv, ww, p, pi, pj, d=dd)
            check_equal("dtw_mv", got, dtw_wavefront_plain(qv, cv, ww, p, pi, pj, d=dd),
                        f"d={dd} n={nn} w={ww} p={p} ({npair} pairs, path {slots})")
            if p != math.inf:
                bnd = (got * torch.as_tensor(rng.uniform(0.3, 1.6, npair), device=dev)
                       .to(got.dtype)).contiguous()
                ab = dtw_launch(qv, cv, ww, p, pi, pj, bnd, d=dd)
                check_equal("dtw_mv", ab, dtw_wavefront_plain(qv, cv, ww, p, pi, pj, bnd, d=dd),
                            f"d={dd} n={nn} w={ww} p={p} with bounds")
                if not bool((ab[got >= bnd] >= bnd[got >= bnd]).all()):
                    fail(f"dtw_mv d={dd} p={p}: an abandoned lane below its bound")
    log(f"[mv] K5's channel entry bit-equal to dtw_wavefront_plain at d={d} and 8 "
        f"(n={n}, w={w}) and on its in-place path (d={MV_LONG[0]}, n={MV_LONG[1]}, "
        f"w={MV_LONG[2]}), p in {{1, 2, inf}}, with and without bounds; paths {lib_slots} "
        f"(-2 staged segments, -3 rows in place)")
    if lib_slots[-1] != -3:
        fail(f"MV_LONG did not take the in-place path ({lib_slots})")

    # times at the path's shapes: the pair list at DTW_CHUNK pairs, the
    # masked entry with the merge on block 1 (the search's final bounds)
    pi = torch.as_tensor(rng.integers(0, nq, DTW_CHUNK), device=dev)
    pj = torch.as_tensor(rng.integers(0, b, DTW_CHUNK), device=dev)
    blk = rows[b : 2 * b]
    ms = time_ms(lambda: dtw_launch(qs, blk, w, 1, pi, pj, d=d))
    dms = device_ms(lambda: dtw_launch(qs, blk, w, 1, pi, pj, d=d))
    plain = time_ms(lambda: dtw_plain(qs, blk, w, 1, pi, pj, d=d), iters=1, repeats=3,
                    warmup=1)
    wave = time_ms(lambda: dtw_wavefront_plain(qs, blk, w, 1, pi, pj, d=d), iters=1,
                   repeats=3, warmup=1)
    ops = 3 * d + 2  # a cell: d (difference, |.|, join), then the DP's min, add, clamp
    bnd, by = bound_ms(4 * DTW_CHUNK * (2 * total + 1), ops * DTW_CHUNK * cells)
    err = check_close("dtw_mv", dtw_launch(qs, blk, w, 1, pi, pj, d=d),
                      dtw_plain(qs, blk, w, 1, pi, pj, d=d), TOL["dtw"], "vs dtw_plain")
    rec["dtw_mv"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=None, device_ms=dms, wavefront_plain_ms=wave,
                         shape=f"pairs={DTW_CHUNK} d={d} n={n} w={w} p=1 full DP",
                         tolerance="bit-equal to dtw_wavefront_plain; 3e-4 to dtw_plain")
    stage = torch.empty((nq, b), dtype=torch.uint8, device=dev)
    lb_fused_prepare(qs, upper, lower, w, final, 1, b, stage, d=d)(blk, b)
    nlive = int((stage == 2).sum())
    mstate = (torch.full((nq, 1), -1.0, device=dev),
              torch.full((nq, 1), -1, dtype=torch.int64, device=dev),
              torch.zeros((3, nq), dtype=torch.int64, device=dev),
              torch.zeros(4, dtype=torch.int64, device=dev))
    out = torch.empty((nq, b), device=dev)
    mrun = dtw_masked_prepare(qs, w, 1, stage, None, out, (*mstate, DTW_CHUNK), d=d)
    mms = time_ms(lambda: mrun(blk, b))
    mdms = device_ms(lambda: mrun(blk, b))
    mplain = time_ms(lambda: dtw_merge_plain(qs, blk, stage, w, 1, None, out, *mstate, b,
                                             DTW_CHUNK, d=d), iters=3, repeats=3, warmup=1)
    mbnd, mby = bound_ms(4 * (nq * total + b * total + nlive) + nq * b + 2 * nq * (4 + 8)
                         + 2 * 8 * (3 * nq + 4), ops * nlive * cells)
    rec["dtw_merge_mv"] = dict(max_abs_err=0.0, ms=mms, plain_ms=mplain, bound_ms=mbnd,
                               bound_by=mby, library_ms=None, device_ms=mdms,
                               shape=f"Q={nq} x B={b} slots, {nlive} live, d={d} n={n} "
                                     f"w={w} p=1, k=1; then the merge",
                               tolerance="bit-equal to dtw_merge_plain(dp=dtw_wavefront_plain)")
    # the folded K3 and K1 at the path's shapes, beside their d = 1 records
    h = lb_keogh_launch(blk, upper, lower, 1)[1]
    k3 = lambda: lb_improved_pass2_qbatch_op(h, qs, w, 1, d)  # noqa: E731
    rec["lb_improved_pass2"].update(
        mv_folded_ms=time_ms(k3), mv_folded_device_ms=device_ms(k3),
        mv_folded_max_abs_err=lb2_err,
        mv_folded_shape=f"Q={nq} B={b} d={d} n={n}: {nq * b * d} rows, then the channel sum")
    seg = rows[:b].reshape(-1, n)
    rec["envelope"].update(mv_segments_device_ms=device_ms(lambda: envelope_launch(seg, w)),
                           mv_segments_shape=f"{b * d} rows of n={n} (B={b}, d={d})")
    log(f"[mv] dtw_mv: {ms:.4f} ms per call ({dms:.5f} on the device) at {DTW_CHUNK} pairs "
        f"vs plain {plain:.3f} ms (wavefront plain {wave:.3f}), bound {bnd:.6f} ms ({by}); "
        f"dtw_merge_mv: {mms:.4f} ms per call ({mdms:.5f} on the device), {nlive} live of "
        f"{nq * b}, vs plain {mplain:.3f} ms, bound {mbnd:.6f} ms ({mby}); folded K3 "
        f"{rec['lb_improved_pass2']['mv_folded_device_ms']:.5f} ms on the device")


def phase_mv(dev, launches, main, rec):
    """The multivariate tier on the card: the MV_SESSION default session
    through the host driver's device loop, its exactness gate, its kernels
    against their plain versions, the scan-route session with every method,
    and an (N, n, 1) build of phase 3's rows."""
    import numpy as np
    import torch

    from repro_torch.api import Database, SearchConfig
    from repro_torch.core.cascade import nn_search_host
    from repro_torch.kernels.dtw.ops import dtw_qbatch_op
    from repro_torch.mv import dtw_reference_mv

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    n_rows, n, d = MV_SESSION
    x = mv_walks(rng, n_rows, n, d)
    queries = mv_walks(rng, N_QUERIES, n, d)
    torch.cuda.synchronize()

    def build():
        t0 = time.perf_counter()
        db = Database.build(x)
        torch.cuda.synchronize()
        return db, time.perf_counter() - t0

    db, build_s = counted(launches, "mv build", build)
    plan = db.plan(queries).explain()
    if not plan.startswith("driver: host") or f"channels: {d}" not in plan:
        fail(f"the mv session did not route to the host driver with channels: {d}:\n{plan}")

    def search():
        t0 = time.perf_counter()
        res = db.search(queries)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res, search_s = counted(launches, "mv search", search)
    busy_ms, wall_ms, by_kernel = device_busy(lambda: db.search(queries))
    s = res.stats
    log(f"[mv] {db!r} ({n_rows * n * d * 4 / 1e6:.1f} MB of rows); build {build_s:.2f} s, "
        f"search of {N_QUERIES} queries {search_s:.3f} s = {N_QUERIES / search_s:.2f} qps")
    log("[mv] plan: " + " | ".join(plan.splitlines()[:4]))
    log(f"[mv] pruned {s.pruned_by}, full_dtw {s.full_dtw} of {s.n_candidates}, blocks "
        f"{s.blocks_total}, DP chunks {s.blocks_dtw}, DP lanes "
        f"{s.dp_lane_useful}/{s.dp_lane_work}")
    log(f"[mv] launches: build {launches['mv build']}; search {launches['mv search']}")
    if busy_ms > 0:
        log(f"[mv] profiled second search: device busy {busy_ms:.1f} ms of {wall_ms:.1f} "
            f"ms wall = idle share {1 - busy_ms / wall_ms:.3f}")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
        log("[mv] device ms by kernel: " + "; ".join(
            f"{k[:56]} {ms:.1f} ms / {c}" for k, (ms, c) in top))
        k5 = [(ms, c) for k, (ms, c) in by_kernel.items() if "dtw_kernel" in k]
        if k5:
            log(f"[mv] K5's channel entry in the search: {k5[0][0] / k5[0][1]:.4f} ms a "
                f"launch over {k5[0][1]} launches")
    else:
        log("[mv] profiled second search: the profiler saw no device time; idle share "
            "not measured")
    got = launches["mv search"]
    nb = s.blocks_total
    require_launched(launches, "mv build", ("envelope", "lb_kim", "lb_keogh",
                                            "lb_improved_pass2", "dtw_mv"), "mv build")
    if ((got["lb_keogh"], got["lb_improved_pass2"], got["dtw_merge_mv"]) != (nb,) * 3
            or got["envelope"] < 1 or any(got[k] for k in (
                "lb_fused", "dtw", "dtw_mv", "dtw_merge", "block_merge", "lb_kim"))):
        fail(f"mv search: expected K1, then per block ({nb}) one K2, one K3 and one K5 "
             f"masked channel entry with the merge, and no K4, got {got}")
    enqueue_s, loop_s = loop_without_sync(dev, db, queries, res)
    log(f"[mv] the block loop ran again under set_sync_debug_mode('error') in "
        f"{loop_s:.3f} s ({enqueue_s / nb * 1e6:.1f} us of host time a block to enqueue "
        f"it): no synchronisation, same indices, distances and counters")

    # exactness: top-1 of two queries against a brute force by K5's channel
    # entry over every row, every top-1 against the float64 oracle, and the
    # same session with early abandoning
    qs = torch.as_tensor(db.prepare_queries(queries), device=dev).contiguous()
    best = dtw_qbatch_op(qs[:2].contiguous(), db.rows_tensor, db.w, db.p, d=d).argmin(dim=1)
    if not np.array_equal(best.cpu().numpy(), res.indices[:2, 0]):
        fail(f"mv top-1 {res.indices[:2, 0]} != brute force {best.cpu().numpy()}")
    worst = 0.0
    for qi in range(N_QUERIES):
        ref = dtw_reference_mv(queries[qi], x[res.indices[qi, 0]], db.w, db.p)
        worst = max(worst, abs(float(res.distances[qi, 0]) - ref) / abs(ref))
    if worst > 2e-4:
        fail(f"mv distances vs float64 dtw_reference_mv: rel err {worst:.3g} > 2e-4")
    early = nn_search_host(qs, db.rows_tensor, db.w, db.p, 1, db.config.block,
                           method="lb_improved", early_abandon=True, d=d)
    if not (np.array_equal(early.indices, res.indices)
            and np.array_equal(early.distances, res.distances)):
        fail("the mv session with early abandoning answered otherwise")
    log(f"[mv] brute force top-1 {best.tolist()} == session top-1; top-1 vs float64 "
        f"dtw_reference_mv: max rel err {worst:.3g}; early_abandon=True: the same indices "
        f"and distance bits")
    mv_block_checks(dev, db, qs, res, rec)
    kept = {"db": db, "x": x}  # phase 10 serves this session
    del db, x

    # the scan route: every method gives full's indices; tc_tri indexed
    rows, n2, d2 = MV_SCAN
    xs = mv_walks(rng, rows, n2, d2)
    qs2 = mv_walks(rng, 8, n2, d2)

    def scan_all():
        out = {}
        for method in ("full", "lb_keogh", "lb_improved", "lb_webb", "kim_improved",
                       "kim_webb", "tc_box", "auto"):
            sdb = Database.build(xs, SearchConfig(k=5, method=method))
            pl = sdb.plan(qs2).explain()
            if not pl.startswith("driver: scan") or f"channels: {d2}" not in pl:
                fail(f"mv scan {method}: plan\n{pl}")
            out[method] = sdb.search(qs2)
        idb = Database.build(xs, SearchConfig(k=5, method="tc_tri"), index=True,
                             n_refs=MV_SCAN_REFS)
        if not idb.plan(qs2).explain().startswith("driver: indexed"):
            fail("mv tc_tri: the indexed session did not route to the indexed driver")
        out["tc_tri (indexed)"] = idb.search(qs2)
        return out

    scans = counted(launches, "mv scan", scan_all)
    base = scans["full"]
    for method, r in scans.items():
        if not np.array_equal(r.indices, base.indices):
            fail(f"mv scan {method}: indices differ from full's")
        log(f"[mv scan] {method:<17} pruned={r.stats.pruned_by} dtw={r.stats.full_dtw} "
            f"lanes={r.stats.dp_lane_useful}/{r.stats.dp_lane_work}")
    require_launched(launches, "mv scan", ("envelope", "lb_kim", "lb_keogh",
                                           "lb_improved_pass2", "dtw_mv"), "mv scan")
    log(f"[mv scan] {rows} x ({n2}, {d2}): every method gives full's indices; launches "
        f"{launches['mv scan']}")

    # d = 1 stays d = 1: an (N, n, 1) build of phase 3's rows
    def unit_channel():
        db1 = Database.build(main["x"][:, :, None])
        return db1, db1.search(main["queries"])

    db1, r1 = counted(launches, "mv d=1", unit_channel)
    m = main["res"]
    if (db1.channels != 1 or r1.stats.pruned_by != MAIN_PRUNED
            or r1.stats.full_dtw != MAIN_FULL_DTW
            or r1.indices[:2, 0].tolist() != MAIN_TOP1
            or not np.array_equal(r1.indices, m.indices)
            or r1.distances.tobytes() != m.distances.tobytes()):
        fail(f"the (N, n, 1) build answered otherwise than phase 3: {r1.stats}")
    got1 = launches["mv d=1"]
    if got1["dtw_mv"] or got1["dtw_merge_mv"] or not got1["lb_fused"]:
        fail(f"the (N, n, 1) build left the univariate kernels: {got1}")
    log(f"[mv] (N, n, 1) build of phase 3's rows: pruning {r1.stats.pruned_by} / "
        f"{r1.stats.full_dtw}, top-1 {r1.indices[:2, 0].tolist()}, phase 3's distance bits")
    del db1
    log(f"[mv] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return kept


# ------------------------------------------------------------- phase 10

#: the multivariate stream session, phase 7's configuration at d = 3: rows
#: (44 minutes of a 3-axis accelerometer at 100 Hz, 3 MB), rows a push,
#: hop, plants, template length n and channels d
MV_STREAM = (262_144, 4096, 4, 128, 128, 3)
#: the rows the K5c brute force covers (every window there)
MV_STREAM_HEAD = 16_384
#: the noise on a plant, and the rooted thresholds (p = 2), znorm off and on
MV_PLANT_NOISE = 0.02
MV_THRESHOLDS = {False: 2.0, True: 3.0}
#: the mv serve: requests of phase 9's (315, 3), client threads, max_batch;
#: the second engine's session rows (of (128, 3)) and its stream's rows
MV_SERVE = (32, 4, 16)
MV_SERVE_STREAM = (16, 65_536)


def mv_stream_data(rng):
    """Four (128, 3) templates (channel c of template t is the bank's shape
    (t + c) % 4) and a stream of three random-walk channels, the templates
    planted in all channels at the same starts (multiples of the hop, one
    template length apart at least), replacing the walk, with a little
    noise.  Returns (templates, stream (rows, 3), plants [(tid, start)])."""
    import numpy as np

    from repro_torch.data.synthetic import random_walks, template_bank

    n_rows, _, hop, n_plants, n, d = MV_STREAM
    bank = template_bank(n, kinds=("sine", "cosine", "gaussian", "gaussian_inverted"))
    templates = np.stack([np.stack([bank[(t + c) % 4] for c in range(d)], axis=1)
                          for t in range(4)]).astype(np.float32)
    stream = np.ascontiguousarray(random_walks(rng, d, n_rows).T)
    plants = []
    for slot in sorted(rng.choice(n_rows // (2 * n), size=n_plants, replace=False)):
        pos = int(slot) * 2 * n + hop * int(rng.integers(0, n // (2 * hop) + 1))
        tid = int(rng.integers(0, len(templates)))
        noise = MV_PLANT_NOISE * rng.standard_normal((n, d)).astype(np.float32)
        stream[pos : pos + n] = templates[tid] + noise
        plants.append((tid, pos))
    return templates, stream, plants


def mv_rows_of(templates, stream, starts, znorm):
    """The flattened (Q, d*n) template rows and the (B, d*n) window rows at
    ``starts``, channel-major, z-normalized per channel as the scanner
    does it (the templates by ``znorm_series``, the windows from float64
    prefix sums) where ``znorm``."""
    import numpy as np

    from repro_torch.mv.layout import flatten_channels
    from repro_torch.stream import (
        prefix_sums,
        window_mean_std_from_prefix,
        znorm_series,
        znorm_windows,
    )

    q, n, d = templates.shape
    qrows = np.ascontiguousarray(flatten_channels(templates))
    if znorm:
        qrows = np.stack([znorm_series(r) for r in qrows.reshape(q * d, n)]).reshape(q, d * n)
    parts = []
    for c in range(d):
        col = np.ascontiguousarray(stream[:, c])
        wins = np.lib.stride_tricks.sliding_window_view(col, n)[starts]
        if znorm:
            wins = znorm_windows(wins, *window_mean_std_from_prefix(*prefix_sums(col), starts,
                                                                     n))
        parts.append(np.asarray(wins, np.float32))
    return qrows, np.concatenate(parts, axis=1)


def phase_mv_stream_serve(dev, launches, mv):
    """Multivariate streaming and serving: a (128, 3) template bank over a
    3-channel planted stream, znorm off (S1 by K7c) and on (S1 by K2 on the
    copied tile), each equal to the offline scan, to K5c on every match's
    pair and, over the head, to a K5c brute force; then a QueryEngine over
    phase 9's session and one over a 16-row session's stream."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.api import Database, SearchConfig
    from repro_torch.kernels.dtw.ops import dtw_pairs_op, dtw_qbatch_op
    from repro_torch.launch.serve import replay
    from repro_torch.serve import QueryEngine
    from repro_torch.stream import Match, greedy_suppress, windowed_matches
    from repro_torch.stream.subsequence import finish_np, powered_threshold

    t_phase = time.perf_counter()
    n_rows, chunk, hop, _, n, d = MV_STREAM
    rng = np.random.default_rng(SEED + 11)
    templates, stream, plants = mv_stream_data(rng)
    base = SearchConfig(w=12, p=2, block=64, method="lb_improved")
    p = base.p
    key = lambda h: (h.tid, h.start)  # noqa: E731
    for znorm in (False, True):
        tag = f"[mv stream znorm={znorm}]"
        db = Database.build(templates, dataclasses.replace(base, znorm=znorm))
        thr = MV_THRESHOLDS[znorm]
        before = dict(launches.get("mv stream session", {}))

        spent = {"lanes": 0.0, "block": 0.0}

        def run(part=stream):
            t0 = time.perf_counter()
            m = db.stream(threshold=thr, hop=hop)
            sc = m.scanner
            lanes_fn, block_fn = sc._window_lanes, sc.process_block
            spent.update(lanes=0.0, block=0.0)

            def timed_lanes(*a):  # the block's lanes and S0, on the host
                t = time.perf_counter()
                out = lanes_fn(*a)
                spent["lanes"] += time.perf_counter() - t
                return out

            def timed_block(*a):
                t = time.perf_counter()
                out = block_fn(*a)
                spent["block"] += time.perf_counter() - t
                return out

            sc._window_lanes, sc.process_block = timed_lanes, timed_block
            polled = []
            for lo in range(0, part.shape[0], chunk):
                m.push(part[lo : lo + chunk])
                polled += m.poll()
            m.flush()
            polled += m.poll()
            torch.cuda.synchronize()
            return m, polled, time.perf_counter() - t0

        with captured_blocks() as sample:
            m, polled, run_s = counted(launches, "mv stream session", run)
        lanes_s, block_s = spent["lanes"], spent["block"]
        got = {k: v - before.get(k, 0) for k, v in launches["mv stream session"].items()}
        s = m.stats
        blocks = s.blocks_total
        hits = m.matches()
        if sorted(polled, key=lambda h: (h.start, h.tid)) != hits:
            fail(f"{tag} the polled matches differ from matches()")
        if not np.array_equal(s.env_pruned + s.stage_pruned.sum(axis=0) + s.full_dtw,
                              s.n_windows):
            fail(f"{tag} env + stages + dtw != windows: {s}")
        want_k7c = 0 if znorm else blocks
        if (got["lb_keogh_stream_mv"], got["lb_keogh_stream"]) != (want_k7c, 0):
            fail(f"{tag} S1: {got['lb_keogh_stream_mv']} K7c and {got['lb_keogh_stream']} K7 "
                 f"launches in {blocks} blocks, expected {want_k7c} and 0")
        # the offline scan: the same matches and counters (S0 and S1 may
        # split the same lanes otherwise: the live stream's tail envelopes
        # are right-truncated, so only their sum is held)
        t0 = time.perf_counter()
        offline, ostats = counted(launches, "mv stream offline", lambda: windowed_matches(
            stream, templates, db.w, thr, p=p, hop=hop, znorm=znorm, block=base.block, d=d,
            device=dev))
        offline_s = time.perf_counter() - t0
        if offline != hits:
            fail(f"{tag} streamed matches != offline windowed_matches(d={d})")
        same = all(np.array_equal(getattr(s, f), getattr(ostats, f))
                   for f in ("n_windows", "full_dtw", "matched"))
        same &= np.array_equal(s.stage_pruned[1:], ostats.stage_pruned[1:])
        same &= np.array_equal(s.env_pruned + s.stage_pruned[0],
                               ostats.env_pruned + ostats.stage_pruned[0])
        same &= all(getattr(s, f) == getattr(ostats, f) for f in (
            "blocks_total", "blocks_lb2", "blocks_dtw", "dp_lane_work", "dp_lane_useful"))
        if not same:
            fail(f"{tag} stats differ from the offline scan's: {s} vs {ostats}")
        found = sum(any(h.tid == tid and abs(h.start - pos) <= 2 * hop for h in hits)
                    for tid, pos in plants)
        exact = sum((tid, pos) in {key(h) for h in hits} for tid, pos in plants)
        if found != len(plants):
            fail(f"{tag} found {found} of {len(plants)} plants")
        # every match's distance: K5c on its pair, the same bits
        qrows, wrows = mv_rows_of(templates, stream, np.array([h.start for h in hits]), znorm)
        qs_t = torch.as_tensor(qrows, device=dev)
        tids = torch.as_tensor([h.tid for h in hits], device=dev)
        pair_d = dtw_pairs_op(qs_t, torch.as_tensor(wrows, device=dev), tids,
                              torch.arange(len(hits), device=dev), db.w, p, d=d)
        rooted = finish_np(pair_d.cpu().numpy().astype(np.float64), p)
        if rooted.tolist() != [h.dist for h in hits]:
            fail(f"{tag} match distances are not K5c's bits on their pairs")
        # the head: the offline scan against a K5c brute force over every window
        head = stream[:MV_STREAM_HEAD]
        starts = np.arange(0, MV_STREAM_HEAD - n + 1, hop)
        _, hrows = mv_rows_of(templates, head, starts, znorm)
        brute = dtw_qbatch_op(qs_t, torch.as_tensor(hrows, device=dev), db.w, p, d=d)
        bd = brute.cpu().numpy()
        hit = bd <= powered_threshold(np.full(len(templates), thr), p)[:, None]
        brooted = finish_np(bd.astype(np.float64), p)
        braw = [Match(int(q), int(starts[b]), float(brooted[q, b])) for q, b in zip(*np.nonzero(hit))]
        bmatches = greedy_suppress(braw, m.exclusion)
        hmatches, _ = counted(launches, "mv stream offline", lambda: windowed_matches(
            head, templates, db.w, thr, p=p, hop=hop, znorm=znorm, block=base.block, d=d,
            device=dev))
        if hmatches != bmatches:
            fail(f"{tag} the first {MV_STREAM_HEAD:,} rows' matches != a K5c brute force "
                 f"over their {len(templates) * starts.size:,} windows")
        # idle share: a quarter of the stream, profiled
        walls = []

        def part_run():
            walls.append(run(stream[: n_rows // 4])[2])

        prof = profiled_kernels(part_run, f"{tag} profiled quarter")
        busy = sum(us for us, _ in prof.values()) / 1e3
        idle = (f"idle share {1 - busy / (walls[-1] * 1e3):.3f} (device busy {busy:.1f} ms of "
                f"{walls[-1] * 1e3:.1f} ms over {n_rows // 4:,} rows)" if prof
                else "idle share not measured (the profiler saw no device time)")
        windows = int(s.n_windows[0])
        log(f"{tag} {n_rows:,} rows x {d} channels in {chunk}-row chunks, {windows:,} windows x "
            f"{s.n_templates} templates in {blocks} blocks: {run_s:.2f} s = "
            f"{n_rows / run_s:,.0f} rows/s = {n_rows * d / run_s:,.0f} values/s, "
            f"{run_s / blocks * 1e3:.3f} ms a block; {idle}")
        log(f"{tag} per block: lanes and S0 on the host {lanes_s / blocks * 1e3:.3f} ms, "
            f"uploads + stages + syncs + copy back {(block_s - lanes_s) / blocks * 1e3:.3f} "
            f"ms, the rest (pushes into {d} StreamStates, polls, exclusion) "
            f"{(run_s - block_s) / blocks * 1e3:.3f} ms")
        log(f"{tag} matches {len(hits)} (raw hits {int(s.matched.sum())}), plants found "
            f"{found}/{len(plants)} ({exact} at their exact start); pruned S0 "
            f"{int(s.env_pruned.sum()):,}, "
            + ", ".join(f"{k} {int(v.sum()):,}" for k, v in s.pruned_by.items())
            + f", dtw {int(s.full_dtw.sum()):,} of {int(s.n_windows.sum()):,} lanes; launches "
            f"{ {k: v for k, v in got.items() if v} }")
        log(f"{tag} == offline windowed_matches(d={d}) ({offline_s:.2f} s; counters equal, S0 "
            f"{'equal' if np.array_equal(s.env_pruned, ostats.env_pruned) else 'split otherwise'})"
            f"; every match's distance == K5c on its pair, bit for bit; the first "
            f"{MV_STREAM_HEAD:,} rows' {len(hmatches)} matches == a K5c brute force over "
            f"{len(templates) * starts.size:,} windows")
        check_stream_blocks(tag, m.scanner, sample)
        del db, m
    require_launched(launches, "mv stream session", ("lb_keogh_stream_mv", "lb_keogh",
                                                     "dtw_mv"), "mv stream session")

    # serve: phase 9's session behind a QueryEngine, and a second engine's
    # stream session over a 16-row (128, 3) session
    mv_db, x = mv["db"], mv["x"]
    n_req, n_clients, max_batch = MV_SERVE
    n_tpl, s_rows = MV_SERVE_STREAM
    workload = mv_walks(rng, n_req, mv_db.length, mv_db.channels)
    near = rng.integers(0, x.shape[0], n_req // 2)
    workload[::2] = x[near] + 0.1 * rng.standard_normal(x[near].shape).astype(np.float32)
    rows16 = np.concatenate([templates, mv_walks(rng, n_tpl - len(templates), n, d)])
    db16 = Database.build(rows16, base)
    signal = stream[:s_rows]

    def serve():
        engine = QueryEngine(mv_db, max_batch=max_batch)
        t0 = time.perf_counter()
        served = replay(engine, workload, n_clients)
        q_s = time.perf_counter() - t0
        stats = engine.stats()
        engine.close()
        eng16 = QueryEngine(db16, max_batch=4)
        sess = eng16.open_stream(threshold=MV_THRESHOLDS[False], hop=hop)
        streamed = []
        t0 = time.perf_counter()
        for lo in range(0, s_rows, chunk):
            streamed += sess.feed(signal[lo : lo + chunk])
        streamed += sess.close()
        stream_s = time.perf_counter() - t0
        stats16 = eng16.stats()
        eng16.close()
        torch.cuda.synchronize()
        return served, q_s, stats, sess, streamed, stream_s, stats16

    with captured_blocks() as sample:
        served, q_s, stats, sess, streamed, stream_s, stats16 = counted(launches, "mv serve",
                                                                        serve)
    direct = mv_db.search(workload)
    for qi, _, ans in served:
        if not (np.array_equal(ans.distances, direct.distances[qi])
                and np.array_equal(ans.indices, direct.indices[qi])):
            fail(f"[mv serve] request {qi}: the engine's answer is not a direct db.search's")
    ref = db16.stream(threshold=MV_THRESHOLDS[False], hop=hop)
    for lo in range(0, s_rows, chunk):
        ref.push(signal[lo : lo + chunk])
    ref.flush()
    if sorted(streamed, key=lambda h: (h.start, h.tid)) != ref.matches():
        fail("[mv serve] the stream session's matches differ from a direct db.stream's")
    for f in ("n_windows", "env_pruned", "stage_pruned", "full_dtw", "matched"):
        if not np.array_equal(getattr(sess.stats, f), getattr(ref.stats, f)):
            fail(f"[mv serve] the stream session's {f} differs from a direct db.stream's")
    if stats16.stream_samples != s_rows * d:
        fail(f"[mv serve] stream_samples {stats16.stream_samples} != {s_rows} rows x {d}")
    lat_ms = np.sort([1e3 * dt for _, dt, _ in served])
    log(f"[mv serve] {len(served)} requests of ({mv_db.length}, {mv_db.channels}) from "
        f"{n_clients} clients (max_batch {max_batch}) over {mv_db.n_rows:,} rows in "
        f"{q_s:.3f} s = {len(served) / q_s:.2f} qps; latency p50 "
        f"{np.percentile(lat_ms, 50):.1f} ms, p99 {np.percentile(lat_ms, 99):.1f} ms; batches "
        f"{stats.batches}, occupancy {stats.batch_occupancy:.2f}; every answer == a direct "
        f"db.search (indices and distance bits)")
    log(f"[mv serve] open_stream on a {n_tpl}-row ({n}, {d}) session: {s_rows:,} rows in "
        f"{stream_s:.2f} s = {s_rows / stream_s:,.0f} rows/s, {len(streamed)} matches == a "
        f"direct db.stream's, stats equal, stream_samples {stats16.stream_samples:,} = rows x "
        f"{d}; launches {({k: v for k, v in launches['mv serve'].items() if v})}")
    require_launched(launches, "mv serve", ("lb_keogh", "lb_improved_pass2", "dtw_merge_mv",
                                            "lb_keogh_stream_mv"), "mv serve")
    check_stream_blocks("[mv serve stream]", sess.matcher.scanner, sample)
    log(f"[mv stream] phase 10 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------- phase 11

#: the sharded phase: blocks between bound exchanges, ranks of the gloo
#: run on the one card and each rank's process timeout (s)
SYNC_EVERY, GLOO_RANKS, RANK_TIMEOUT = 4, 2, 240

#: one rank of the gloo run: phase 3's rows from SEED, padded for
#: GLOO_RANKS shards, its shard swept on cuda:0; its result as JSON
GLOO_RANK = r"""
import dataclasses, datetime, json, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out, n_rows, length, n_queries, seed, w, sync_every = sys.argv[1:]
rank, world = int(rank), int(world)
torch.set_num_threads(1)  # the stages run on the card; two ranks share the host
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
from repro_torch.core.distributed import Mesh, pad_database, sharded_nn_search
from repro_torch.data.synthetic import random_walks

rng = np.random.default_rng(int(seed))
x = random_walks(rng, int(n_rows), int(length))
queries = random_walks(rng, int(n_queries), int(length))
mesh = Mesh((world,), ("data",), device="cuda:0")
dbp, _ = pad_database(x, mesh, block=32)
torch.cuda.synchronize()
dist.barrier()
t0 = time.perf_counter()
res = sharded_nn_search(queries, dbp, mesh, w=int(w), p=1, k=1, block=32,
                        sync_every=int(sync_every))
seconds = time.perf_counter() - t0
dist.destroy_process_group()
json.dump(dict(idx=res.indices.tolist(), dist=res.distances.astype(float).tolist(),
               stats=dataclasses.asdict(res.stats), seconds=seconds,
               per_query=[dataclasses.asdict(s) for s in res.per_query]), open(out, "w"))
"""


@contextlib.contextmanager
def captured_scan_blocks(keep_first: int = 2, keep_dtw: int = 2):
    """Keep a few of the blocks the scan body runs while the context is
    open: the first ``keep_first``, the first ``keep_dtw`` after them whose
    DP ran, and the last one; each with its tile, its bound, the stages'
    masks and its queries with their envelopes.  Yields the list, filled
    when the context ends."""
    from repro_torch.core import pipeline as pipe

    stages = pipe.run_block_stages
    kept, last, seen = [], [], [0, 0]

    def run_stages(*a, **kw):
        res = stages(*a, **kw)
        blk = dict(blk=a[6], bound=a[7], masks=res.masks, index=seen[0], qs=a[0],
                   upper=a[1], lower=a[2])
        seen[0] += 1
        if blk["index"] < keep_first:
            kept.append(blk)
        elif res.need_dtw and seen[1] < keep_dtw:
            seen[1] += 1
            kept.append(blk)
        else:
            last[:] = [blk]
        return res

    pipe.run_block_stages = run_stages
    try:
        yield kept
    finally:
        pipe.run_block_stages = stages
        kept += last


def check_scan_blocks(tag, qs, upper, lower, w, p, blocks):
    """A route's kernels against their plain versions on blocks it ran: K2
    dense (rtol 1e-4, H bit-equal), K2 and K3 on the pairs that passed
    LB_Keogh (K3 rtol 2e-4), and K5 on the pairs that reached the DP with
    the block's bound as each lane's bound (bit-equal to
    ``dtw_wavefront_plain``).  ``qs`` None takes each block's own queries
    and envelopes (the anytime routes run one query at a time).  Returns
    the pairs checked by K3 and K5."""
    from repro_torch.kernels.dtw.ops import dtw_launch, dtw_wavefront_plain
    from repro_torch.kernels.lb_improved.ops import (
        lb_improved_pass2_launch,
        lb_improved_pass2_plain,
    )
    from repro_torch.kernels.lb_keogh.ops import lb_keogh_launch, lb_keogh_plain

    pairs = [0, 0]
    own = qs is None
    for b in blocks:
        blk, bound, masks = b["blk"], b["bound"], b["masks"]
        if own:
            qs, upper, lower = b["qs"], b["upper"], b["lower"]
        what = f"{tag} block {b['index']} (Q={qs.shape[0]} B={blk.shape[0]} w={w} p={p})"
        lb, h = lb_keogh_launch(blk, upper, lower, p)
        lbp, hp = lb_keogh_plain(blk, upper, lower, p)
        check_close("lb_keogh", lb, lbp, TOL["lb_keogh"], what)
        check_close("lb_keogh", h, hp, 0.0, f"{what} H")
        qi, ci = masks[1].nonzero(as_tuple=True)
        if qi.numel():
            lb, h = lb_keogh_launch(blk, upper, lower, p, qi, ci)
            lbp, hp = lb_keogh_plain(blk, upper, lower, p, qi, ci)
            check_close("lb_keogh", lb, lbp, TOL["lb_keogh"], f"{what} pairs")
            check_close("lb_keogh", h, hp, 0.0, f"{what} pairs H")
            check_close("lb_improved_pass2", lb_improved_pass2_launch(h, qs, w, p, qi),
                        lb_improved_pass2_plain(h, qs, w, p, qi), TOL["lb_improved_pass2"],
                        f"{what}, {qi.numel()} pairs past LB_Keogh")
            pairs[0] += qi.numel()
        qi, ci = masks[-1].nonzero(as_tuple=True)
        if qi.numel():
            bounds = bound[qi].contiguous()
            check_equal("dtw", dtw_launch(qs, blk, w, p, qi, ci, bounds),
                        dtw_wavefront_plain(qs, blk, w, p, qi, ci, bounds),
                        f"{what}, {qi.numel()} DP pairs with the bound")
            pairs[1] += qi.numel()
    if not all(pairs):
        fail(f"{tag}: the captured blocks held no pair for K3 or K5 ({pairs})")
    return pairs


def phase_sharded(dev, launches, main):
    """The sharded driver on phase 3's rows: one NCCL rank through
    ``make_host_mesh`` and ``Database.use_mesh`` against the scan driver
    on the same rows, then two gloo ranks on the one card against it."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import Database
    from repro_torch.core.cascade import nn_search_scan
    from repro_torch.kernels.envelope.ops import envelope_op
    from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes

    t_phase = time.perf_counter()
    x, queries = main["x"], main["queries"]
    mesh = make_host_mesh()
    if mesh.backend != "nccl" or mesh_axis_sizes(mesh) != {"data": 1, "model": 1}:
        fail(f"make_host_mesh() on one card gave {mesh!r}")
    db = Database.build(x).use_mesh(mesh, sync_every=SYNC_EVERY)
    plan = db.plan(queries)
    if plan.driver != "sharded":
        fail(f"a session with a mesh did not route to the sharded driver:\n{plan.explain()}")

    def search():
        t0 = time.perf_counter()
        res = db.search(queries)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # NCCL sets its communicator up at the first collective: not in the timing
    mesh.shard_group(mesh.axis_names).all_reduce(torch.zeros(1, device=dev),
                                                 torch.distributed.ReduceOp.MIN)
    with captured_scan_blocks() as blocks:
        res, search_s = counted(launches, "sharded", search)
    got = launches["sharded"]
    log(f"[sharded] one NCCL rank, {db!r}, sync_every={SYNC_EVERY}: search of {N_QUERIES} "
        f"queries {search_s:.2f} s = {N_QUERIES / search_s:.2f} qps; launches "
        f"{({k: v for k, v in got.items() if v})}")
    require_launched(launches, "sharded", ("envelope", "lb_keogh", "lb_improved_pass2", "dtw"),
                     "sharded search")
    if got["lb_fused"] or got["dtw_merge"]:
        fail(f"the sharded search ran the host driver's loop: {got}")

    # the scan driver on the same rows and queries: the same sweep, but pad
    # and poison lanes are neither swept nor counted
    qs = torch.as_tensor(db.prepare_queries(queries), device=dev)
    t0 = time.perf_counter()
    scan = nn_search_scan(qs, db.rows_tensor, db.w, db.p, k=1, block=BLOCK)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    if not np.array_equal(res.indices, scan.indices):
        fail(f"sharded indices != nn_search_scan's: {res.indices[:, 0]} vs {scan.indices[:, 0]}")
    if res.distances.tobytes() != scan.distances.tobytes():
        fail("sharded distances are not nn_search_scan's bits")
    n_pad = -(-N_ROWS // BLOCK) * BLOCK
    nb = n_pad // BLOCK
    poison = (-(-nb // SYNC_EVERY) * SYNC_EVERY - nb) * BLOCK
    extra = n_pad - N_ROWS + poison  # pad and poison lanes, pruned by LB_Keogh
    s, t = res.stats, scan.stats
    for a, b in zip(res.per_query, scan.per_query):
        want = dataclasses.replace(b, n_candidates=n_pad, stage_pruned=(
            b.stage_pruned[0] + extra, *b.stage_pruned[1:]))
        if a != want:
            fail(f"sharded counters {a} != nn_search_scan's plus {extra} pad and poison "
                 f"lanes {want}")
    log(f"[sharded] == nn_search_scan ({scan_s:.2f} s): indices, distance bits, every counter, "
        f"lb_keogh + {extra} pad and poison lanes a query ({nb} blocks, {poison // BLOCK} "
        f"poison blocks); pruned {s.pruned_by}, full_dtw {s.full_dtw}, DP lanes "
        f"{s.dp_lane_useful}/{s.dp_lane_work}")
    host = main["res"]
    held = {"lb_keogh": t.pruned_by["lb_keogh"] == MAIN_PRUNED["lb_keogh"],
            "lb_improved": t.pruned_by["lb_improved"] == MAIN_PRUNED["lb_improved"],
            "full_dtw": t.full_dtw == MAIN_FULL_DTW}
    log(f"[sharded] the scan body's counts against the host loop's (phase 3): "
        + ", ".join(f"{k} {'held' if v else 'differs'}" for k, v in held.items())
        + f" (scan {t.pruned_by} / {t.full_dtw}; host {MAIN_PRUNED} / {MAIN_FULL_DTW}); "
        f"indices {'==' if np.array_equal(res.indices, host.indices) else '!='} phase 3's, "
        f"distance bits {'==' if res.distances.tobytes() == host.distances.tobytes() else '!='}")
    if not np.array_equal(res.indices, host.indices):
        fail(f"sharded top-1 {res.indices[:, 0]} != phase 3's {host.indices[:, 0]}")
    upper, lower = envelope_op(qs, db.w)
    pairs = check_scan_blocks("[sharded]", qs, upper, lower, db.w, db.p, blocks)
    log(f"[sharded] {len(blocks)} of the sweep's blocks (the last "
        f"{'a poison block' if poison else 'the last real block'}): K2 dense, "
        f"K2 and K3 on {pairs[0]} pairs past LB_Keogh, K5 on {pairs[1]} DP pairs with the "
        f"block's bound == their plain versions")

    # two gloo ranks on the one card (NCCL takes one rank a device): each
    # makes phase 3's rows, sweeps its half and returns the merged result
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(GLOO_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", GLOO_RANK, str(r), str(GLOO_RANKS), os.path.join(tmp, "store"),
             outs[r], str(N_ROWS), str(LENGTH), str(N_QUERIES), str(SEED), str(db.w),
             str(SYNC_EVERY)],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(GLOO_RANKS)]
        errors = []
        for r, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=RANK_TIMEOUT)
            except subprocess.TimeoutExpired:
                for other in procs:
                    other.kill()
                out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"gloo rank {r}: exit {proc.returncode}\n{out}\n{err}")
        if errors:
            fail("\n".join(errors))
        ranks = [json.loads(pathlib.Path(o).read_text()) for o in outs]
        gloo_s = time.perf_counter() - t0
    first = ranks[0]
    if any({k: v for k, v in r.items() if k != "seconds"}
           != {k: v for k, v in first.items() if k != "seconds"} for r in ranks[1:]):
        fail("the gloo ranks returned different results")
    if first["idx"] != res.indices.tolist():
        fail(f"gloo ranks' indices != the one-rank run's: {first['idx']} vs {res.indices}")
    if np.asarray(first["dist"], np.float32).tobytes() != res.distances.tobytes():
        fail("gloo ranks' distances are not the one-rank run's bits")
    n_pad = -(-N_ROWS // (GLOO_RANKS * BLOCK)) * GLOO_RANKS * BLOCK
    nb_local = n_pad // GLOO_RANKS // BLOCK
    lanes = GLOO_RANKS * -(-nb_local // SYNC_EVERY) * SYNC_EVERY * BLOCK
    for q in first["per_query"]:
        if sum(q["stage_pruned"]) + q["full_dtw"] != lanes or q["n_candidates"] != n_pad:
            fail(f"gloo rank counters do not close over the {lanes} lanes swept: {q}")
    g = first["stats"]
    log(f"[sharded] {GLOO_RANKS} gloo ranks on cuda:0, {n_pad:,} padded rows: "
        f"{gloo_s:.1f} s with start-up, the search {max(r['seconds'] for r in ranks):.2f} s; "
        f"both ranks' results equal, indices and distance bits == the one-rank run; counters "
        f"close over {lanes:,} lanes a query (pruned {g['stage_pruned']}, full_dtw "
        f"{g['full_dtw']})")
    log(f"[sharded] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return res


# ------------------------------------------------------------ phase 12

#: the anytime tier's subsequence build: phase 3's first rows at these
#: lengths (default hop m // 4: 12 windows of 256 a row; the host's
#: leaf clustering grows with the square of the windows a cluster, so the
#: rows are cut to keep the phase near a minute), the rows of the
#: session saved and loaded through an .npz file at the same lengths, the
#: coarse clusters whose radii are checked by ``dtw_reference`` (whole-row
#: tier, then the 256 tier), and the windows of a captured sweep chunk
#: held against K5's plain version
ANYTIME_SUB = (10_000, (256, LENGTH))
ANYTIME_BUNDLE_ROWS = 2_000
ANYTIME_ORACLE = (2, 8)
SWEEP_CHECK_ROWS = 128


@contextlib.contextmanager
def timed_anytime_build(keep: int = SWEEP_CHECK_ROWS):
    """Time the anytime tier inside ``Database.build`` while the context is
    open: its whole build (``build_anytime_index``) and its K5 radius
    sweeps (``anytime/cluster.py::_rep_dists``: wall clock, and the device
    stream's span by CUDA events), count the sweeps' launches, and keep the
    first and last chunk of every sweep (``keep`` windows of each, with the
    representatives, band and p) to hold K5 against its plain version.
    Yields the record, filled when the context ends."""
    import torch

    from repro_torch.anytime import cluster
    from repro_torch.api import database

    sweep, qbatch = cluster._rep_dists, cluster.dtw_qbatch_op
    build = database.build_anytime_index
    rec = dict(tier_s=0.0, sweep_s=0.0, sweep_device_s=0.0, sweeps=0, sweep_launches=0,
               chunks=[])
    ends: list = []

    def dtw_qbatch(qs, cands, w, p=1, *a, **kw):
        rec["sweep_launches"] += 1
        if not ends:
            ends.append((qs, cands[:keep], w, p))
        ends[1:] = [(qs, cands[-keep:], w, p)]
        return qbatch(qs, cands, w, p, *a, **kw)

    def rep_dists(reps, wins, w, p, *a, **kw):
        ends.clear()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = sweep(reps, wins, w, p, *a, **kw)
        end.record()
        end.synchronize()
        rec["sweep_s"] += time.perf_counter() - t0
        rec["sweep_device_s"] += start.elapsed_time(end) / 1e3
        rec["sweeps"] += 1
        rec["chunks"] += ends
        return out

    def build_index(*a, **kw):
        t0 = time.perf_counter()
        out = build(*a, **kw)
        torch.cuda.synchronize()
        rec["tier_s"] += time.perf_counter() - t0
        return out

    cluster._rep_dists, cluster.dtw_qbatch_op = rep_dists, dtw_qbatch
    database.build_anytime_index = build_index
    try:
        yield rec
    finally:
        cluster._rep_dists, cluster.dtw_qbatch_op = sweep, qbatch
        database.build_anytime_index = build


def check_sweep_chunks(tag, chunks) -> int:
    """K5's dense entry against ``dtw_wavefront_plain`` (bit-equal) on the
    captured chunks of the radius sweeps; returns the pairs checked."""
    from repro_torch.kernels.dtw.ops import dtw_launch, dtw_wavefront_plain

    pairs = 0
    for reps, cands, w, p in chunks:
        what = (f"{tag} sweep chunk ({reps.shape[0]} representatives x {cands.shape[0]} "
                f"windows of {cands.shape[1]}, w={w}, p={p})")
        check_equal("dtw", dtw_launch(reps, cands, w, p), dtw_wavefront_plain(reps, cands, w, p),
                    what)
        pairs += reps.shape[0] * cands.shape[0]
    return pairs


def check_anytime_tier(tag, db, m, n_oracle, rng) -> tuple[int, float]:
    """The tree's invariants on one tier: representatives and leaf members
    partition the window ids; on ``n_oracle`` sampled coarse clusters every
    member lies in its leaf's box, every leaf box in its cluster's box,
    ``radii_w`` is K5's max over the members at band w and
    ``min_radii_wide`` its min at the wide band (the same bits), and each
    radius bounds ``dtw_reference`` of its representative to two members
    (the extreme one and a random one) within rtol 2e-4.  Returns the
    oracle calls and their worst relative error against K5."""
    import numpy as np
    import torch

    from repro_torch.core.dtw import dtw_reference, finish_cost
    from repro_torch.index.triangle_lb import wide_band
    from repro_torch.kernels.dtw.ops import dtw_qbatch_op

    li = db.anytime.tier(m)
    t = li.tree
    if not np.array_equal(np.sort(np.concatenate([t.rep_gid, t.members])),
                          np.arange(li.n_windows)):
        fail(f"{tag} m={m}: representatives and leaf members do not partition the "
             f"{li.n_windows} windows")
    if t.leaf_start[-1] != t.n_leaves or t.member_start[-1] != t.n_members:
        fail(f"{tag} m={m}: the CSR offsets do not close")
    calls, worst = 0, 0.0
    for c in rng.choice(t.n_coarse, size=min(n_oracle, t.n_coarse), replace=False):
        leaves = t.coarse_leaves(int(c))
        if not len(leaves):
            continue
        mem = np.concatenate([t.leaf_members(lf) for lf in leaves])
        rows = li.wins[torch.as_tensor(mem, device=li.wins.device)]
        host = rows.cpu().numpy()
        if (host < t.cmin0[c]).any() or (host > t.cmax0[c]).any():
            fail(f"{tag} m={m}: cluster {c}'s box does not hold its members")
        for lf in leaves:
            inner = li.wins[torch.as_tensor(t.leaf_members(lf), device=li.wins.device)]
            inner = inner.cpu().numpy()
            if ((inner < t.cmin1[lf]).any() or (inner > t.cmax1[lf]).any()
                    or (t.cmin1[lf] < t.cmin0[c]).any() or (t.cmax1[lf] > t.cmax0[c]).any()):
                fail(f"{tag} m={m}: leaf {lf} of cluster {c} is not nested in its boxes")
        rep = li.wins[int(t.rep_gid[c])]
        rep_host = rep.cpu().numpy()
        for band, radius, pick, side in ((li.w, t.radii_w[c], np.argmax, 1.0),
                                         (wide_band(li.w, m), t.min_radii_wide[c], np.argmin,
                                          -1.0)):
            d = finish_cost(dtw_qbatch_op(rep[None], rows, band, db.p), db.p)[0]
            d = d.to(torch.float32).cpu().numpy()
            j = int(pick(d))
            if d[j] != radius:
                fail(f"{tag} m={m}: cluster {c}'s radius at band {band} is {radius}, K5's "
                     f"extreme over its {mem.size} members {d[j]}")
            for i in (j, int(rng.integers(mem.size))):
                ref = dtw_reference(rep_host, host[i], band, db.p)
                worst = max(worst, abs(float(d[i]) - ref) / max(ref, 1e-30))
                if side * (float(radius) - ref) < -2e-4 * ref:
                    fail(f"{tag} m={m}: cluster {c}'s radius {radius} at band {band} does not "
                         f"bound dtw_reference {ref} to member {mem[i]}")
                calls += 1
    if worst > 2e-4:
        fail(f"{tag} m={m}: K5 against dtw_reference: rel err {worst:.3g} > 2e-4")
    return calls, worst


def same_tiers(tag, got, want):
    """Two sessions' anytime tiers: the same lengths, bands, window bits,
    provenance and every tree array's bits."""
    import numpy as np
    import torch

    from repro_torch.anytime.build import _TREE_FIELDS

    if got.anytime.lengths != want.anytime.lengths or repr(got.anytime) != repr(want.anytime):
        fail(f"{tag}: {got.anytime!r} != {want.anytime!r}")
    for m in want.anytime.lengths:
        a, b = got.anytime.tier(m), want.anytime.tier(m)
        if (a.m, a.hop, a.w) != (b.m, b.hop, b.w) or not torch.equal(a.wins, b.wins):
            fail(f"{tag} m={m}: the window bank or its band differs")
        for f in ("row_ids", "starts"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                fail(f"{tag} m={m}: {f} differs")
        for f in _TREE_FIELDS:
            x, y = getattr(a.tree, f), getattr(b.tree, f)
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                fail(f"{tag} m={m}: tree array {f} differs")


def phase_anytime(dev, launches, main):
    """The anytime tier's build side on phase 3's rows: the whole-row tier
    (``anytime=True``) with its K5 radius sweeps, the tree's invariants,
    an in-memory bundle round trip, the exact search's bits; then the
    first 10,000 rows at lengths (256, 1,000) and a 2,000-row session of
    that configuration through ``save``/``load``."""
    import math
    import tempfile

    import numpy as np
    import torch

    from repro_torch.anytime.cluster import SWEEP_CHUNK
    from repro_torch.api import Database

    t_phase = time.perf_counter()
    x, queries, host = main["x"], main["queries"], main["res"]
    rng = np.random.default_rng(SEED + 12)

    def build(rows, anytime):
        def run():
            with timed_anytime_build() as rec:
                t0 = time.perf_counter()
                db = Database.build(rows, anytime=anytime)
                torch.cuda.synchronize()
                rec["build_s"] = time.perf_counter() - t0
            return db, rec
        return run

    def report(tag, db, rec, phase):
        lens = db.anytime.lengths
        want = sum(2 * -(-db.anytime.tier(m).n_windows // SWEEP_CHUNK) for m in lens)
        got = launches[phase]["dtw"]
        if rec["sweeps"] != 2 * len(lens) or rec["sweep_launches"] != want or got < want:
            fail(f"{tag}: expected {2 * len(lens)} radius sweeps of {want} K5 launches in all, "
                 f"got {rec['sweeps']} sweeps, {rec['sweep_launches']} sweep launches and "
                 f"{got} dtw launches in the build")
        tiers = "; ".join(
            f"m={m}: W={li.n_windows:,}, C={li.tree.n_coarse}, {li.tree.n_leaves:,} leaves, "
            f"w={li.w}" for m, li in sorted(db.anytime.by_len.items()))
        host_s = rec["tier_s"] - rec["sweep_s"]
        log(f"[anytime] {tag}: {db!r}; {tiers}")
        log(f"[anytime] {tag}: build {rec['build_s']:.3f} s = the session "
            f"{rec['build_s'] - rec['tier_s']:.3f} s + the tier {rec['tier_s']:.3f} s (host "
            f"{host_s:.3f} s: slicing, sketches, clustering, boxes, copies; K5 radius sweeps "
            f"{rec['sweep_s']:.3f} s wall, {rec['sweep_device_s']:.3f} s on the device "
            f"stream, {rec['sweep_launches']} launches); launches {launches[phase]}")

    # the whole-row tier: W = 100,000, C = min(32, isqrt(W))
    db, rec = counted(launches, "anytime build", build(x, True))
    li = db.anytime.tier(LENGTH)
    if li.wins is not db.rows_tensor:
        fail("the whole-row tier's window bank is not the session's rows tensor")
    if li.tree.n_coarse != min(32, math.isqrt(N_ROWS)) or li.w != db.w:
        fail(f"whole-row tier: C={li.tree.n_coarse}, w={li.w}")
    report("whole-row tier", db, rec, "anytime build")
    pairs = check_sweep_chunks("[anytime] whole-row", rec["chunks"])
    calls, worst = check_anytime_tier("[anytime] whole-row", db, LENGTH, ANYTIME_ORACLE[0], rng)
    log(f"[anytime] whole-row tier: K5 == dtw_wavefront_plain on {len(rec['chunks'])} sweep "
        f"chunks ({pairs:,} pairs); the tree partitions the windows, sampled boxes hold "
        f"their members and nest, sampled radii are K5's extremes and bound "
        f"dtw_reference ({calls} calls, max rel err {worst:.3g})")
    t0 = time.perf_counter()
    back = Database.from_arrays(db.to_arrays())
    torch.cuda.synchronize()
    arrays_s = time.perf_counter() - t0
    same_tiers("[anytime] from_arrays(to_arrays())", back, db)
    if back.anytime.tier(LENGTH).wins is not back.rows_tensor:
        fail("from_arrays did not put the whole-row tier on the session's rows tensor")

    def search():
        res = db.search(queries)
        torch.cuda.synchronize()
        return res

    res = counted(launches, "anytime search", search)
    if not np.array_equal(res.indices, host.indices) or (
            res.distances.tobytes() != host.distances.tobytes()):
        fail(f"the anytime session's exact search {res.indices[:, 0]} is not phase 3's "
             f"{host.indices[:, 0]} bit for bit")
    log(f"[anytime] bundle arrays round trip in memory {arrays_s:.2f} s: every tier array's "
        f"bits, the whole-row bank on the rows tensor; exact search == phase 3's indices and "
        f"distance bits; launches {launches['anytime search']}")
    del back, res

    # the subsequence tiers: the first rows at (256, 1,000), hop 64
    n_sub, lengths = ANYTIME_SUB
    sub, rec = counted(launches, "anytime sub build", build(x[:n_sub], dict(lengths=lengths)))
    report(f"{n_sub:,} rows at lengths {lengths}", sub, rec, "anytime sub build")
    if sub.anytime.tier(lengths[0]).hop != lengths[0] // 4:
        fail(f"the {lengths[0]} tier's hop is {sub.anytime.tier(lengths[0]).hop}")
    pairs = check_sweep_chunks("[anytime] sub", rec["chunks"])
    calls, worst = 0, 0.0
    for m, n_oracle in zip(lengths, ANYTIME_ORACLE[::-1]):
        got = check_anytime_tier("[anytime] sub", sub, m, n_oracle, rng)
        calls += got[0]
        worst = max(worst, got[1])
    log(f"[anytime] subsequence tiers: K5 == dtw_wavefront_plain on {len(rec['chunks'])} "
        f"sweep chunks ({pairs:,} pairs); tree invariants and radii held ({calls} "
        f"dtw_reference calls, max rel err {worst:.3g})")

    small = Database.build(x[:ANYTIME_BUNDLE_ROWS], anytime=dict(lengths=lengths))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = small.save(f"{tmp}/anytime")
        size = os.path.getsize(path)
        loaded = Database.load(path)
        torch.cuda.synchronize()
        io_s = time.perf_counter() - t0
    same_tiers("[anytime] save/load", loaded, small)
    if (loaded.search(queries[:2]).distances.tobytes()
            != small.search(queries[:2]).distances.tobytes()):
        fail("the loaded anytime session answers differently")
    log(f"[anytime] {ANYTIME_BUNDLE_ROWS:,} rows at lengths {lengths} ({small.anytime!r}): "
        f"save + load of {size / 1e6:.1f} MB in {io_s:.2f} s, every tier array's bits and the "
        f"search's distance bits kept")
    log(f"[anytime] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return dict(db=db, sub=sub)  # phase 13 searches both tiers


# ------------------------------------------------------------ phase 13

#: the anytime tier's search side: phase 3's queries searched on phase
#: 12's whole-row tier, unlimited; the budgets (windows refined a query)
#: of the ladder of one of them; the subsequence length of phase 12's
#: 10,000-row session, whose queries are phase 3's first ones cut to it,
#: and the budget they are searched at beside the exact routes
ANYTIME_QUERIES = 2
ANYTIME_LADDER = (32, 1024, 8192)
ANYTIME_SUB_LEN, ANYTIME_SUB_BUDGET = 256, 2048


def anytime_line(res, secs, nq) -> str:
    s = res.stats
    return (f"refined {s.refined:,}, clusters_explored {s.clusters_explored:,} of "
            f"{s.clusters_total:,}, nodes_expanded {s.nodes_expanded}, full_dtw "
            f"{s.full_dtw:,}, pruned {s.pruned_by}, residual_lb {s.residual_lb:.6g}, "
            f"{secs / nq:.3f} s a query")


def sound_against(tag, res, exact_d):
    """Budgeted answers against the exact ones: ``0 <= d_j - t_j <= err_j``
    (the slack of ``tests/test_anytime_soundness.py``)."""
    import numpy as np

    d = np.asarray(res.distances, np.float64)
    t = np.asarray(exact_d, np.float64)
    gap = d - t
    if (res.indices < 0).any() or (gap < -1e-9).any() or (gap > res.error_bounds + 1e-9).any():
        fail(f"{tag}: unsound bound: distances {d.tolist()}, exact {t.tolist()}, error bounds "
             f"{res.error_bounds.tolist()}")


def phase_anytime_search(dev, launches, main, tiers):
    """The anytime tier's search side on phase 12's sessions: ``mode=
    "anytime"`` on the whole-row tier against phase 3's answers, a budget
    ladder with sound error bounds, the subsequence tier's exact route and
    anytime answers against a K5 brute force over the bank; K1, K2, K3
    and K5 against their plain versions on what the refinement ran."""
    import numpy as np
    import torch

    from repro_torch.core.dtw import finish_cost
    from repro_torch.kernels.dtw.ops import dtw_qbatch_op
    from repro_torch.kernels.envelope.ops import envelope_launch, envelope_plain

    t_phase = time.perf_counter()
    db, sub = tiers["db"], tiers["sub"]
    queries, host = main["queries"], main["res"]
    nq = ANYTIME_QUERIES
    qs = queries[:nq]

    def timed_search(session, q, **kw):
        def run():
            t0 = time.perf_counter()
            res = session.search(q, **kw)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        return run

    # (a) the whole-row tier, unlimited: phase 3's bits, every bound 0
    plan = db.plan(qs, mode="anytime")
    if plan.driver != "anytime" or plan.stages[0] != "cluster_lb":
        fail(f"mode='anytime' did not plan the anytime route:\n{plan.explain()}")
    with captured_scan_blocks() as blocks:
        res, secs = counted(launches, "anytime mode", timed_search(db, qs, mode="anytime"))
    got = launches["anytime mode"]
    require_launched(launches, "anytime mode", ("envelope", "lb_keogh", "lb_improved_pass2",
                                                "dtw"), "anytime search")
    if got["lb_fused"] or got["dtw_merge"]:
        fail(f"the anytime search ran the host driver's loop: {got}")
    if not np.array_equal(res.indices, host.indices[:nq]) or (
            res.distances.tobytes() != host.distances[:nq].tobytes()):
        fail(f"unlimited anytime {res.indices[:, 0]} is not phase 3's {host.indices[:nq, 0]} "
             f"bit for bit")
    if not (res.error_bounds == 0).all():
        fail(f"unlimited anytime error bounds {res.error_bounds.tolist()} are not 0")
    log(f"[anytime search] whole-row tier, {nq} queries, no budget: == phase 3's indices and "
        f"distance bits, error bounds 0; {anytime_line(res, secs, nq)}; launches "
        f"{({k: v for k, v in got.items() if v})}")
    pairs = check_scan_blocks("[anytime search]", None, None, None, db.w, db.p, blocks)

    # (b) the budget ladder on one query: sound bounds, distances never rise
    last = None
    for budget in ANYTIME_LADDER:
        r, secs = counted(launches, "anytime mode", timed_search(db, qs[0], mode="anytime",
                                                                 budget=budget))
        sound_against(f"[anytime search] budget {budget}", r, host.distances[0])
        if last is not None and (r.distances > last).any():
            fail(f"budget {budget}: distances {r.distances} rose from {last}")
        last = r.distances
        log(f"[anytime search] budget {budget:,}: distance {r.distances.tolist()} (exact "
            f"{host.distances[0].tolist()}), error bound {r.error_bounds.tolist()}; "
            f"{anytime_line(r, secs, 1)}")

    # (c) the subsequence tier: phase 3's first queries cut to its length
    m = ANYTIME_SUB_LEN
    li = sub.anytime.tier(m)
    sq = queries[:nq, :m]
    plan = sub.plan(sq)
    if plan.driver != "subsequence":
        fail(f"a length-{m} query did not plan the subsequence route:\n{plan.explain()}")
    q_t = torch.as_tensor(np.ascontiguousarray(sub.prepare_queries(sq, length=m)), device=dev)
    brute = finish_cost(dtw_qbatch_op(q_t, li.wins, li.w, sub.p), sub.p).cpu().numpy()
    k = sub.config.k
    order = np.stack([np.lexsort((np.arange(li.n_windows), d))[:k] for d in brute])
    want_d = np.take_along_axis(brute, order, axis=1)
    with captured_scan_blocks() as sub_blocks:
        exact, exact_s = counted(launches, "anytime sub search", timed_search(sub, sq))
        anyt, anyt_s = counted(launches, "anytime sub search",
                               timed_search(sub, sq, mode="anytime"))
    for tag, r in (("exact route", exact), ("anytime, no budget", anyt)):
        if not np.array_equal(r.indices, order) or r.distances.tobytes() != want_d.tobytes():
            fail(f"subsequence {tag}: {r.indices.tolist()} / {r.distances.tolist()} is not the "
                 f"K5 brute force's {order.tolist()} / {want_d.tolist()} bit for bit")
        if not (r.error_bounds == 0).all():
            fail(f"subsequence {tag}: error bounds {r.error_bounds.tolist()}")
    budgeted, budget_s = counted(launches, "anytime sub search",
                                 timed_search(sub, sq, mode="anytime", budget=ANYTIME_SUB_BUDGET))
    sound_against(f"[anytime search] subsequence budget {ANYTIME_SUB_BUDGET}", budgeted, want_d)
    require_launched(launches, "anytime sub search", ("envelope", "lb_keogh",
                                                      "lb_improved_pass2", "dtw"),
                     "subsequence search")
    log(f"[anytime search] subsequence tier m={m} (W={li.n_windows:,}, "
        f"{li.tree.n_leaves:,} leaves, w={li.w}), {nq} queries: the exact route and "
        f"unlimited anytime == the K5 brute force over the bank (indices {order[:, 0].tolist()}, "
        f"distance bits), error bounds 0; exact {exact_s / nq:.3f} s a query "
        f"({exact.stats.refined // nq:,} windows, full_dtw {exact.stats.full_dtw:,}); "
        f"anytime {anytime_line(anyt, anyt_s, nq)}")
    log(f"[anytime search] subsequence budget {ANYTIME_SUB_BUDGET:,}: distances "
        f"{budgeted.distances[:, 0].tolist()} (exact {want_d[:, 0].tolist()}), error bounds "
        f"{budgeted.error_bounds[:, 0].tolist()}; {anytime_line(budgeted, budget_s, nq)}; "
        f"launches {({k: v for k, v in launches['anytime sub search'].items() if v})}")

    # (d) the kernels against their plain versions on what the routes ran
    for tag, qt, w in (("whole-row", torch.as_tensor(db.prepare_queries(qs), device=dev), db.w),
                       ("subsequence", q_t, li.w)):
        check_equal("envelope", envelope_launch(qt, w), envelope_plain(qt, w),
                    f"[anytime search] {tag} query envelopes ({qt.shape[0]} x {qt.shape[1]}, "
                    f"w={w})")
    sub_pairs = check_scan_blocks("[anytime search] sub", None, None, None, li.w, sub.p,
                                  sub_blocks)
    log(f"[anytime search] K1 bit-equal on the query envelopes; on {len(blocks)} whole-row and "
        f"{len(sub_blocks)} subsequence blocks of the refinement: K2 dense, K2 and K3 on "
        f"{pairs[0] + sub_pairs[0]} pairs past LB_Keogh, K5 on {pairs[1] + sub_pairs[1]} DP pairs "
        f"with the gate == their plain versions")
    log(f"[anytime search] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return dict(sub_anytime=anyt, sub_budgeted=budgeted)  # phase 14 serves the same


# ------------------------------------------------------------ phase 14

#: anytime serving: the engines' max_batch; the budgets of the whole-row
#: requests (phase 3's first query at the first, its second at the
#: second) and of the interleaved mixed requests; the deadline (s) that
#: maps onto a budget once the refine-rate EMA is seeded; the launch key
#: of the anytime requests (K4 and K5m must not run under it)
SERVE_ANYTIME_BATCH = 4
SERVE_ANYTIME_BUDGETS = (1024, 8192)
SERVE_MIXED_BUDGET = 4096
SERVE_ANYTIME_DEADLINE = 0.05
SERVE_ANYTIME_KEY = "14: anytime serving"
#: the search CLI's anytime run (rows, length, queries, tier lengths,
#: query length), and the budget of its second run
ANYTIME_CLI = (2048, 512, 4, (128, 512), 128)
ANYTIME_CLI_BUDGET = 256
ANYTIME_CLI_LINE = (r"query (\d+): nn=(\d+) dist=([0-9.]+) err<=([0-9.]+|inf) "
                    r"refined=(\d+)/(\d+) clusters=(\d+)/(\d+) ")


def same_anytime_answer(tag, got, want):
    """An engine's anytime answer against a direct search's result: the
    same indices, distance bits and error-bound bits."""
    import numpy as np

    for f in ("indices", "distances", "error_bounds"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            fail(f"{tag}: {f} {a.tolist()} are not the direct search's {b.tolist()} bit "
                 f"for bit")


def phase_anytime_serve(dev, launches, main, tiers, searched, smi):
    """The anytime tier's serving on phase 12's sessions: a ``QueryEngine``
    over the whole-row tier (unlimited requests with phase 3's bits,
    budgeted ones bit-equal to a direct search, a cache hit, a deadline
    mapped onto a budget by the refine-rate EMA, exact requests
    interleaved, the stats the sums of the answers), one over the 256 tier
    with phase 13's bits, the kernels on the refinement's blocks against
    their plain versions; then the search CLI's anytime flags and the
    classify twin as subprocesses against direct in-process runs."""
    import re

    import numpy as np
    import torch

    from repro_torch.api import Database, SearchConfig
    from repro_torch.data.synthetic import cylinder_bell_funnel, random_walks
    from repro_torch.serve import QueryEngine

    t_phase = time.perf_counter()
    db, sub = tiers["db"], tiers["sub"]
    queries, host = main["queries"], main["res"]
    qs = queries[:ANYTIME_QUERIES]
    key = SERVE_ANYTIME_KEY
    answers = []  # (mode, answer) of every request the whole-row engine served

    def request(engine, q, **kw):
        def run():
            t0 = time.perf_counter()
            a = engine.submit(q, **kw).result(timeout=300)
            torch.cuda.synchronize()
            return a, time.perf_counter() - t0
        return run

    def direct(session, q, **kw):
        t0 = time.perf_counter()
        r = session.search(q, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    engine = QueryEngine(db, max_batch=SERVE_ANYTIME_BATCH)
    sub_engine = QueryEngine(sub, max_batch=SERVE_ANYTIME_BATCH)
    procs: dict[str, subprocess.Popen] = {}
    try:
        # (a) unlimited: phase 3's queries, one lane each, phase 3's bits
        def unlimited():
            t0 = time.perf_counter()
            futures = [engine.submit(q, mode="anytime") for q in qs]
            got = [f.result(timeout=300) for f in futures]
            torch.cuda.synchronize()
            return got, time.perf_counter() - t0

        with captured_scan_blocks() as blocks:
            got, unlimited_s = counted(launches, key, unlimited)
        for i, a in enumerate(got):
            if not np.array_equal(a.indices, host.indices[i]) or (
                    a.distances.tobytes() != host.distances[i].tobytes()):
                fail(f"[anytime serve] unlimited request {i}: {a.indices} / {a.distances} "
                     f"are not phase 3's {host.indices[i]} / {host.distances[i]}")
            if a.error_bounds is None or (a.error_bounds != 0).any():
                fail(f"[anytime serve] unlimited request {i}: error bounds {a.error_bounds}")
        answers += [("anytime", a) for a in got]
        seeded = engine._refine_rate
        log(f"[anytime serve] whole-row tier, {len(qs)} unlimited requests in "
            f"{unlimited_s:.3f} s ({unlimited_s / len(qs):.3f} s a request, batch lanes "
            f"{[a.batch_lanes for a in got]}): phase 3's indices and distance bits, error "
            f"bounds 0; refined {[a.stats.refined for a in got]}; the EMA seeded at "
            f"{seeded:,.0f} windows/s ({smi})")

        # (b) budgeted, bit-equal to a direct search; (c) the cache hit
        for i, budget in enumerate(SERVE_ANYTIME_BUDGETS):
            a, engine_s = counted(launches, key, request(engine, qs[i], mode="anytime",
                                                         budget=budget))
            r, direct_s = direct(db, qs[i], mode="anytime", budget=budget)
            same_anytime_answer(f"[anytime serve] budget {budget}", a, r)
            sound_against(f"[anytime serve] budget {budget}", a, host.distances[i])
            answers.append(("anytime", a))
            log(f"[anytime serve] budget {budget:,}: {engine_s:.4f} s a request through the "
                f"engine, {direct_s:.4f} s a direct search ({engine_s - direct_s:+.4f} s), "
                f"bit-equal to it, error bound {a.error_bound:.6g}, refined "
                f"{a.stats.refined:,}, clusters {a.stats.clusters_explored:,}; EMA "
                f"{engine._refine_rate:,.0f} windows/s ({smi})")
        cold = a  # the last budgeted request, resubmitted
        hit, hit_s = counted(launches, key, request(engine, qs[1], mode="anytime",
                                                    budget=SERVE_ANYTIME_BUDGETS[1]))
        if not hit.cache_hit or hit.error_bounds.tobytes() != cold.error_bounds.tobytes():
            fail(f"[anytime serve] the resubmitted request was no cache hit with the same "
                 f"bounds: {hit}")
        answers.append(("anytime", hit))

        # (d) a deadline mapped onto a budget by the seeded EMA
        rate = engine._refine_rate
        want_budget = max(1, int(rate * SERVE_ANYTIME_DEADLINE))
        a, deadline_s = counted(launches, key, request(engine, qs[1], mode="anytime",
                                                       deadline=SERVE_ANYTIME_DEADLINE))
        if a.stats.budget != want_budget:
            fail(f"[anytime serve] deadline {SERVE_ANYTIME_DEADLINE} s at {rate:.6g} "
                 f"windows/s: budget {a.stats.budget}, not {want_budget}")
        sound_against("[anytime serve] deadline", a, host.distances[1])
        answers.append(("anytime", a))
        log(f"[anytime serve] cache hit in {hit_s * 1e3:.3f} ms with the same bounds; "
            f"deadline {SERVE_ANYTIME_DEADLINE} s at {rate:,.0f} windows/s -> budget "
            f"{want_budget:,}, served in {deadline_s:.4f} s, error bound {a.error_bound:.6g} "
            f"({smi})")
        if launches[key]["lb_fused"] or launches[key]["dtw_merge"]:
            fail(f"[anytime serve] the anytime requests ran the host driver's loop: "
                 f"{launches[key]}")

        # (e) exact requests interleaved with anytime ones, in two tenants
        batches = engine.stats().batches

        def mixed():
            futures = []
            for q in qs:
                futures.append(("anytime", engine.submit(q, mode="anytime", tenant="anytime",
                                                         budget=SERVE_MIXED_BUDGET)))
                futures.append(("exact", engine.submit(q, tenant="exact")))
            got = [(mode, f.result(timeout=300)) for mode, f in futures]
            torch.cuda.synchronize()
            return got

        got = counted(launches, "14: mixed serving", mixed)
        for i, (mode, a) in enumerate(got):
            q = qs[i // 2]
            if mode == "exact":
                r, _ = direct(db, q)
                if a.error_bounds is not None or not np.array_equal(a.indices, r.indices) or (
                        a.distances.tobytes() != r.distances.tobytes()):
                    fail(f"[anytime serve] interleaved exact request {i}: {a} is not a direct "
                         f"db.search's {r}")
            else:
                r, _ = direct(db, q, mode="anytime", budget=SERVE_MIXED_BUDGET)
                same_anytime_answer(f"[anytime serve] interleaved anytime request {i}", a, r)
            if a.batch_lanes > len(qs):
                fail(f"[anytime serve] request {i} shared a batch of {a.batch_lanes} lanes "
                     f"across modes")
        mixed_batches = engine.stats().batches - batches
        if mixed_batches < 2:
            fail(f"[anytime serve] exact and anytime requests ran in {mixed_batches} batch")
        answers += got

        # (f) the stats: the sums over the answers served
        st = engine.stats()
        anytime = [a for mode, a in answers if mode == "anytime"]
        want = dict(served=len(answers), anytime_served=len(anytime),
                    cache_hits=sum(a.cache_hit for _, a in answers),
                    clusters_explored=sum(a.stats.clusters_explored for a in anytime
                                          if not a.cache_hit))
        have = {f: getattr(st, f) for f in want}
        mean = sum(a.error_bound for a in anytime) / len(anytime)
        if have != want or not math.isclose(st.residual_bound_mean, mean, rel_tol=1e-12):
            fail(f"[anytime serve] engine stats {have}, residual_bound_mean "
                 f"{st.residual_bound_mean}; the answers sum to {want}, {mean}")
        log(f"[anytime serve] interleaved: {len(got)} requests in {mixed_batches} batches, "
            f"exact answers == direct db.search, anytime ones == direct mode='anytime' "
            f"(budget {SERVE_MIXED_BUDGET:,}); engine stats == the answers' sums: {have}, "
            f"residual_bound_mean {st.residual_bound_mean:.6g}; launches "
            f"{({k: v for k, v in launches['14: mixed serving'].items() if v})}")

        # (g) the 256 tier of the 10,000-row session: phase 13's bits
        m = ANYTIME_SUB_LEN
        sq = queries[:ANYTIME_QUERIES, :m]
        sub_lines = []
        with captured_scan_blocks() as sub_blocks:
            for tag, budget, want_res in (
                    ("no budget", None, searched["sub_anytime"]),
                    (f"budget {ANYTIME_SUB_BUDGET:,}", ANYTIME_SUB_BUDGET,
                     searched["sub_budgeted"])):
                for i, q in enumerate(sq):
                    a, secs = counted(launches, key, request(sub_engine, q, mode="anytime",
                                                             budget=budget))
                    same_anytime_answer(f"[anytime serve] sub tier {tag} query {i}", a,
                                        want_res[i])
                    sub_lines.append(f"{tag} query {i} {secs:.4f} s")
        log(f"[anytime serve] the {m} tier of the {sub.n_rows:,}-row session: "
            f"submit(mode='anytime') == phase 13's indices, distance and bound bits; "
            f"{'; '.join(sub_lines)} a request ({smi})")
        got = launches[key]
        require_launched(launches, key, ("envelope", "lb_keogh", "lb_improved_pass2", "dtw"),
                         "anytime serving")
        if got["lb_fused"] or got["dtw_merge"]:
            fail(f"[anytime serve] the anytime requests ran the host driver's loop: {got}")

        # the CLI runs and the classify twin, while the blocks are checked
        n_rows, length, n_q, lengths, qlen = ANYTIME_CLI
        cli = ["-m", "repro_torch.launch.search", "--db-size", str(n_rows), "--length",
               str(length), "--queries", str(n_q), "--anytime", ",".join(map(str, lengths)),
               "--mode", "anytime", "--query-length", str(qlen)]
        t_sub = time.perf_counter()
        for budget in (None, ANYTIME_CLI_BUDGET):
            procs[f"budget {budget}"] = start_python(
                cli + ([] if budget is None else ["--budget", str(budget)]))
        procs["classify"] = start_python(["examples/classify_timeseries_torch.py"])
        pairs = check_scan_blocks("[anytime serve]", None, None, None, db.w, db.p, blocks)
        sub_pairs = check_scan_blocks("[anytime serve] sub", None, None, None,
                                      sub.anytime.tier(m).w, sub.p, sub_blocks)
        log(f"[anytime serve] on {len(blocks)} whole-row and {len(sub_blocks)} subsequence "
            f"blocks the engine's worker ran: K2 dense, K2 and K3 on "
            f"{pairs[0] + sub_pairs[0]} pairs past LB_Keogh, K5 on {pairs[1] + sub_pairs[1]} "
            f"DP pairs with the gate == their plain versions; launches "
            f"{({k: v for k, v in got.items() if v})}")

        # the direct runs the subprocesses are held against
        rng = np.random.default_rng(0)  # the CLI's --seed default
        data = random_walks(rng, n_rows, length)
        cli_q = random_walks(rng, n_q, qlen)
        cli_db = Database.build(data, SearchConfig(), anytime=dict(lengths=lengths), seed=0)
        cli_want = {budget: cli_db.search(cli_q, mode="anytime", budget=budget)
                    for budget in (None, ANYTIME_CLI_BUDGET)}
        rng = np.random.default_rng(0)  # the example's data
        train_x, train_y = cylinder_bell_funnel(rng, 6)
        test_x, test_y = cylinder_bell_funnel(rng, 10)
        w = train_x.shape[1] // 10

        def classify():
            return {("inf" if p == math.inf else p): float(np.mean(
                Database.build(train_x, SearchConfig(w=w, p=p)).classify(train_y, test_x)
                == test_y)) for p in (1, 2, math.inf)}

        accs = counted(launches, "14: classify", classify)
        require_launched(launches, "14: classify", ("envelope", "lb_keogh", "dtw"),
                         "db.classify")
        del cli_db

        for budget in (None, ANYTIME_CLI_BUDGET):
            what = f"launch.search --anytime ... budget {budget}"
            out = finish_python(procs.pop(f"budget {budget}"), what)
            rows = [re.match(ANYTIME_CLI_LINE, ln) for ln in out.splitlines()
                    if ln.startswith("query ")]
            if len(rows) != n_q or not all(rows):
                fail(f"{what}: unparsable query lines:\n{out}")
            if any(ln.startswith("mesh=") for ln in out.splitlines()):
                fail(f"{what}: the anytime route attached a mesh:\n{out}")
            want = cli_want[budget]
            nn = [int(r.group(2)) for r in rows]
            refined = [int(r.group(5)) for r in rows]
            if nn != want.indices[:, 0].tolist() or refined != [
                    s.stats.refined for s in want.per_query]:
                fail(f"{what}: nn {nn}, refined {refined}; the direct search: "
                     f"{want.indices[:, 0].tolist()}, "
                     f"{[s.stats.refined for s in want.per_query]}")
            served = [ln for ln in out.splitlines() if ln.startswith("served")]
            log(f"[anytime serve] {what}: nn {nn} and refined {refined} == a direct search "
                f"of the same rows; {rows[0].group(0).strip()} | {' | '.join(served)}")
        out = finish_python(procs.pop("classify"), "examples/classify_timeseries_torch.py")
        printed = dict(re.findall(r"^DTW_(\w+): accuracy ([0-9.]+)", out, re.M))
        for name, acc in accs.items():
            if printed.get(str(name)) != f"{acc:.3f}":
                fail(f"classify_timeseries_torch.py: DTW_{name} printed "
                     f"{printed.get(str(name))}, a direct db.classify gives {acc:.3f}")
        if "4" not in printed or "CPU" not in out:
            fail(f"classify_timeseries_torch.py: no DTW_4 row on the CPU:\n{out}")
        log(f"[anytime serve] subprocesses in {time.perf_counter() - t_sub:.1f} s; "
            f"classify_timeseries_torch.py: accuracies {printed} (p in {{1, 2, inf}} == a "
            f"direct db.classify on the card, launches "
            f"{({k: v for k, v in launches['14: classify'].items() if v})})")
    finally:
        for proc in procs.values():
            proc.kill()
            proc.communicate()
        engine.close()
        sub_engine.close()
    log(f"[anytime serve] phase 14 took {time.perf_counter() - t_phase:.1f} s ({smi})")


# ------------------------------------------------------------ phase 15

#: the sharded serving phase: the engine's batch, the repeated query and
#: the k=2 request (query indices), the launch key, and the twin's last line
SERVE_MESH_BATCH, SERVE_MESH_REPEAT, SERVE_MESH_K2 = 8, 3, 5
SERVE_MESH_KEY = "15: sharded serving"
SERVICE_LAST = "all answers match the single-device scan."

#: one gloo rank of the sharded engine: phase 3's session on cuda:0 with a
#: (2,) mesh, warmed by one sharded search; once the file ``go`` exists
#: (the twin beside it has ended, so the timed part runs alone) rank 0
#: serves two tenants, rank 1 follows and holds K2, K3 and K5 against their
#: plain versions on two blocks of its first mirrored search; its answers,
#: launches and times as JSON
SERVE_RANK = r"""
import dataclasses, datetime, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

(rank, world, store, out, go, n_rows, length, n_queries, seed, sync_every, batch, repeat,
 k2) = sys.argv[1:]
rank, world, batch = int(rank), int(world), int(batch)
torch.set_num_threads(1)  # the stages run on the card; the ranks share the host
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
import chip_smoke as cs
from repro_torch.api import Database
from repro_torch.core.distributed import Mesh
from repro_torch.data.synthetic import random_walks
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.serve import QueryEngine

rng = np.random.default_rng(int(seed))
x = random_walks(rng, int(n_rows), int(length))
queries = random_walks(rng, int(n_queries), int(length))
t0 = time.perf_counter()
db = Database.build(x).use_mesh(Mesh((world,), ("data",), device="cuda:0"),
                                sync_every=int(sync_every))
torch.cuda.synchronize()
got = dict(build_s=time.perf_counter() - t0, plan=db.plan(queries[:batch]).driver)
blocks = []
search = db.search
search(queries[:batch])  # the first search's one-off costs, not timed


def first_captured(block, **kw):
    # the follower's first mirrored search keeps its first blocks
    if blocks or rank == 0:
        return search(block, **kw)
    with cs.captured_scan_blocks(keep_first=1, keep_dtw=1) as kept:
        res = search(block, **kw)
    blocks.append(kept[:2])
    return res


db.search = first_captured
engine = QueryEngine(db, max_batch=batch, max_wait_ms=2.0, start=False)
torch.cuda.synchronize()
while not os.path.exists(go):
    time.sleep(0.05)
dist.barrier()
reset_launch_counts()
if rank == 0:
    futures = [engine.submit(q, tenant=("a", "b")[i % 2]) for i, q in enumerate(queries)]
    t0 = time.perf_counter()
    engine.start()
    answers = [f.result(timeout=600) for f in futures]
    got["served_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    answers.append(engine.submit(queries[int(repeat)], tenant="a").result(timeout=60))
    got["hit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    answers.append(engine.submit(queries[int(k2)], tenant="b", k=2).result(timeout=600))
    got["k2_s"] = time.perf_counter() - t0
    got["answers"] = [dict(idx=a.indices.tolist(), dist=a.distances.astype(float).tolist(),
                           cache_hit=a.cache_hit, lanes=a.batch_lanes, wait_ms=a.wait_ms)
                      for a in answers]
    got["stats"] = dataclasses.asdict(engine.stats())
else:
    engine.start()
engine.close(timeout=600)
torch.cuda.synchronize()
got["launches"] = launch_counts()
got["mirrored"] = engine.mirrored_batches
# the same batches straight to the session, on every rank in turn
t0 = time.perf_counter()
direct = [search(queries[i : i + batch]) for i in range(0, len(queries), batch)]
torch.cuda.synchronize()
got["direct_s"] = time.perf_counter() - t0
got["direct"] = dict(idx=np.concatenate([r.indices for r in direct]).tolist(),
                     dist=np.concatenate([r.distances for r in direct]).astype(float).tolist())
if rank == 1:
    pairs = cs.check_scan_blocks("[sharded serve] rank 1", None, None, None, db.w, db.p,
                                 blocks[0])
    got["checked"] = dict(blocks=len(blocks[0]), pairs=pairs)
dist.destroy_process_group()
json.dump(got, open(out, "w"))
"""


def phase_sharded_serve(dev, launches, main, sharded, smi):
    """A ``QueryEngine`` over phase 3's session on a two-rank gloo mesh on
    the one card (subprocesses): rank 0 serves two tenants, rank 1 mirrors
    its sharded batches; the answers phase 11's bits; the search service
    twin at its defaults beside their set-up (the timed part runs after
    it)."""
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    host = main["res"]
    procs = {"twin": start_python(["examples/search_service_torch.py"])}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            outs = [os.path.join(tmp, f"rank{r}.json") for r in range(GLOO_RANKS)]
            go = pathlib.Path(tmp) / "go"
            for r in range(GLOO_RANKS):
                procs[f"rank {r}"] = start_python(
                    ["-c", SERVE_RANK, str(r), str(GLOO_RANKS), os.path.join(tmp, "store"),
                     outs[r], str(go), str(N_ROWS), str(LENGTH), str(N_QUERIES), str(SEED),
                     str(SYNC_EVERY), str(SERVE_MESH_BATCH), str(SERVE_MESH_REPEAT),
                     str(SERVE_MESH_K2)])
            out = finish_python(procs.pop("twin"), "examples/search_service_torch.py")
            lines = out.strip().splitlines()
            if not lines or not lines[-1].endswith(SERVICE_LAST):
                fail(f"examples/search_service_torch.py did not end with its check line:\n"
                     f"{out}")
            log(f"[sharded serve] examples/search_service_torch.py (8 gloo ranks on the card, "
                f"beside the two ranks' set-up): {lines[0]} | {lines[-1]}")
            go.touch()
            for r in range(GLOO_RANKS):  # a failure kills the rest (finally)
                finish_python(procs[f"rank {r}"], f"[sharded serve] gloo rank {r}",
                              timeout=RANK_TIMEOUT)
                del procs[f"rank {r}"]
            ranks = [json.loads(pathlib.Path(o).read_text()) for o in outs]
        lead, follower = ranks
        if any(r["plan"] != "sharded" for r in ranks):
            fail(f"[sharded serve] the session did not route to the sharded driver: "
                 f"{[r['plan'] for r in ranks]}")
        answers = lead["answers"]
        idx = [a["idx"] for a in answers[:N_QUERIES]]
        dist_bits = np.asarray([a["dist"] for a in answers[:N_QUERIES]], np.float32)
        if idx != sharded.indices.tolist() or dist_bits.tobytes() != sharded.distances.tobytes():
            fail(f"[sharded serve] the engine's answers are not phase 11's one-rank bits: "
                 f"{[i[0] for i in idx]} vs {sharded.indices[:, 0].tolist()}")
        if [i[0] for i in idx] != host.indices[:, 0].tolist():
            fail(f"[sharded serve] top-1 {[i[0] for i in idx]} != phase 3's "
                 f"{host.indices[:, 0].tolist()}")
        for r in ranks:
            if r["direct"] != dict(idx=idx, dist=[a["dist"] for a in answers[:N_QUERIES]]):
                fail("[sharded serve] a direct sharded search of the engine's batches gave "
                     "other bits than the engine")
        hit, k2 = answers[N_QUERIES:]
        if not hit["cache_hit"] or hit["idx"] != idx[SERVE_MESH_REPEAT]:
            fail(f"[sharded serve] the repeated query was not a cache hit: {hit}")
        if k2["idx"][:1] != idx[SERVE_MESH_K2] or np.float32(k2["dist"][0]) != dist_bits[
                SERVE_MESH_K2][0]:
            fail(f"[sharded serve] the k=2 answer's first neighbour {k2} is not the k=1 one")
        st = lead["stats"]
        n_batches = N_QUERIES // SERVE_MESH_BATCH + 1
        if (st["batches"], st["cache_hits"], st["served"]) != (n_batches, 1, N_QUERIES + 2):
            fail(f"[sharded serve] engine stats {st}")
        if (lead["mirrored"], follower["mirrored"]) != (n_batches, n_batches):
            fail(f"[sharded serve] rank 0 sent {lead['mirrored']} batches, rank 1 ran "
                 f"{follower['mirrored']}; {n_batches} sharded batches were served (the cache "
                 f"hit is not sent)")
        for r, got in enumerate(ranks):
            counts = got["launches"]
            for name in ("envelope", "lb_keogh", "lb_improved_pass2", "dtw"):
                if counts[name] <= 0:
                    fail(f"[sharded serve] rank {r} did not launch {name}: {counts}")
            if counts["lb_fused"] or counts["dtw_merge"]:
                fail(f"[sharded serve] rank {r} ran the host driver's loop: {counts}")
        launches[SERVE_MESH_KEY] = {k: lead["launches"][k] + follower["launches"][k]
                                    for k in lead["launches"]}
        checked = follower["checked"]
        per_request = lead["served_s"] / N_QUERIES
        log(f"[sharded serve] {GLOO_RANKS} gloo ranks on cuda:0, QueryEngine(max_batch="
            f"{SERVE_MESH_BATCH}): {N_QUERIES} requests from 2 tenants in "
            f"{lead['served_s']:.3f} s ({per_request:.4f} s a request), the direct sharded "
            f"search of the same {n_batches - 1} batches, warm, {lead['direct_s']:.3f} s (engine / "
            f"direct {lead['served_s'] / lead['direct_s']:.3f}); cache hit "
            f"{1e3 * lead['hit_s']:.2f} ms, k=2 request {lead['k2_s']:.3f} s; builds "
            f"{lead['build_s']:.1f}/{follower['build_s']:.1f} s ({smi})")
        log(f"[sharded serve] == phase 11's indices and distance bits, top-1 == phase 3's; "
            f"rank 1 mirrored {follower['mirrored']} batches (not the cache hit); launches "
            f"rank 0 {({k: v for k, v in lead['launches'].items() if v})}, rank 1 "
            f"{({k: v for k, v in follower['launches'].items() if v})}; rank 1's first "
            f"mirrored search, {checked['blocks']} blocks: K2 dense, K2 and K3 on "
            f"{checked['pairs'][0]} pairs past LB_Keogh, K5 on {checked['pairs'][1]} DP pairs "
            f"== their plain versions")
    finally:
        for proc in procs.values():
            proc.kill()
            proc.communicate()
    log(f"[sharded serve] phase 15 took {time.perf_counter() - t_phase:.1f} s ({smi})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: repro_torch not found next to this script: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    spent: dict[str, float] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        lap(name)
        out = fn(*args)
        lap()
        spent[name] = time.perf_counter() - t0
        return out

    smi = timed("1 toolchain and build", phase_toolchain)
    rec = timed("2 kernels", phase_kernels, dev)
    timed("2 kernels lb", phase_kernels_lb, dev, rec)
    timed("2 long rows", phase_long_rows, dev, rec)
    launches: dict[str, dict[str, int]] = {}
    main_out = timed("3 main path", phase_main_path, dev, launches)
    timed("3 long session", phase_long_session, dev, launches, main_out)
    timed("4 scan sessions", phase_scan_sessions, dev, launches)
    timed("4 stream ops", phase_stream, dev, launches)
    timed("5 tuned", phase_tuned, dev, launches, main_out)
    timed("6 indexed", phase_indexed, dev, launches, main_out)
    timed("6 search CLI", phase_cli)
    timed("7 stream session", phase_stream_session, dev, launches)
    timed("8 serve", phase_serve, dev, launches, main_out)
    timed("8 stream and serve CLIs", phase_stream_serve_cli)
    mv_out = timed("9 multivariate", phase_mv, dev, launches, main_out, rec)
    timed("10 mv stream and serve", phase_mv_stream_serve, dev, launches, mv_out)
    del mv_out
    sharded = timed("11 sharded", phase_sharded, dev, launches, main_out)
    tiers = timed("12 anytime build", phase_anytime, dev, launches, main_out)
    searched = timed("13 anytime search", phase_anytime_search, dev, launches, main_out, tiers)
    timed("14 anytime serving", phase_anytime_serve, dev, launches, main_out, tiers, searched,
          smi)
    del tiers, searched
    timed("15 sharded serving", phase_sharded_serve, dev, launches, main_out, sharded, smi)
    log("[time] seconds by phase: " + "; ".join(f"{k} {v:.1f}" for k, v in spent.items()))
    log(time_line())
    kernels = []
    for name, r in rec.items():
        source, replaces = SOURCES[name]
        by_phase = {phase: counts[name] for phase, counts in launches.items()}
        if name in OFF_PATH:
            r["on_no_path"] = OFF_PATH[name]
        elif sum(by_phase.values()) <= 0:
            fail(f"kernel {name} was launched on no path")
        extra = {k: v for k, v in r.items()
                 if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_phase.values()), max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], launches_by_phase=by_phase, **extra,
        ))
    if PROFILER_MISSES:
        log(f"[profiler] device ms from CUDA events for {len(PROFILER_MISSES)} "
            f"measurement(s) no profiler session saw: {PROFILER_MISSES}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
