"""Streaming subsequence-matching service launcher (port of
``repro.launch.stream``; DESIGN.md §3.5).

Simulates the production shape of the stream subsystem: an unbounded
noisy signal with planted template occurrences arrives in chunks; a
``StreamMatcher`` — obtained from a ``repro_torch.api.Database`` session
whose rows are the template bank, so template envelopes are built once
and shared across matchers — ingests each chunk (online envelopes on the
host, the windowed cascade on the device, one batched sweep per window
block serves every template) and finalized matches are polled and
printed as the stream advances.  The session runs on the GPU unless
``--device cpu``.

With ``--threshold 0`` (the default) each template's threshold is
calibrated from the head of the stream: half the median exact DTW
distance of the first windows (the banded DP kernel on the session's
device) — far below noise windows, far above planted occurrences for the
synthetic workload.

Usage:
  python -m repro_torch.launch.stream --samples 20000 --length 128 --hop 4 --p 2 --znorm
  python -m repro_torch.launch.stream --samples 8000 --length 64 --p inf --chunk 512
  python -m repro_torch.launch.stream --device cpu --samples 3000 --length 48
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import Database, SearchConfig
from repro_torch.core.dtw import finish_cost
from repro_torch.data.synthetic import planted_stream, template_bank
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.dtw.ops import dtw_qbatch_op
from repro_torch.launch.search import _parse_p
from repro_torch.stream.state import prefix_sums, window_mean_std_from_prefix
from repro_torch.stream.subsequence import znorm_series, znorm_windows


def calibrate_thresholds(
    templates: np.ndarray,
    head: np.ndarray,
    w: int,
    p,
    hop: int,
    znorm: bool,
    frac: float = 0.5,
    max_windows: int = 64,
    device=None,
) -> np.ndarray:
    """Per-template threshold = ``frac`` x median exact DTW distance of
    the stream-head windows (a cheap stand-in for a labelled calibration
    set), the distances from the banded DP on ``device``."""
    n = templates.shape[1]
    starts = np.arange(0, head.size - n + 1, hop)[:max_windows]
    if starts.size == 0:
        raise ValueError("stream head too short to calibrate thresholds")
    wins = np.stack([head[s : s + n] for s in starts])
    qs = templates
    if znorm:
        c1, c2 = prefix_sums(head)
        mean, std = window_mean_std_from_prefix(c1, c2, starts, n)
        wins = znorm_windows(wins, mean, std)
        qs = np.stack([znorm_series(t) for t in templates])
    dev = resolve_device(device)
    qs_t = torch.as_tensor(np.asarray(qs, np.float32), device=dev)
    wins_t = torch.as_tensor(np.asarray(wins, np.float32), device=dev)
    d = finish_cost(dtw_qbatch_op(qs_t, wins_t, w, p), p).cpu().numpy()  # (Q, W)
    return frac * np.median(d, axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=20000, help="stream length")
    ap.add_argument("--length", type=int, default=128, help="template length")
    ap.add_argument("--chunk", type=int, default=1024, help="push chunk size")
    ap.add_argument("--hop", type=int, default=4, help="window stride")
    ap.add_argument("--block", type=int, default=64, help="windows per sweep")
    ap.add_argument("--w", type=int, default=0, help="0 = length/10")
    ap.add_argument("--p", type=_parse_p, default=2, help="1, 2 or inf")
    ap.add_argument(
        "--threshold",
        type=float,
        default=0.0,
        help="match threshold (rooted distance); 0 = auto-calibrate",
    )
    ap.add_argument("--znorm", action="store_true", help="per-window z-norm")
    ap.add_argument(
        "--method",
        choices=("lb_improved", "lb_keogh", "full"),
        default="lb_improved",
    )
    ap.add_argument(
        "--no-prefilter",
        action="store_true",
        help="disable the S0 stream-envelope prune",
    )
    ap.add_argument("--plants", type=int, default=0, help="0 = samples/2000")
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    n = args.length
    w = args.w or max(n // 10, 1)
    templates = template_bank(n, kinds=("sine", "gaussian"))
    n_plants = args.plants or max(args.samples // 2000, 1)
    stream, plants = planted_stream(
        rng, args.samples, templates, n_plants, noise_level=args.noise
    )

    if args.threshold > 0:
        thr = np.full(templates.shape[0], args.threshold)
    else:
        thr = calibrate_thresholds(
            templates, stream[: min(4096, args.samples)], w, args.p,
            args.hop, args.znorm, device=device,
        )
    print(
        f"stream={args.samples} samples, {len(plants)} planted occurrences; "
        f"templates={templates.shape[0]}x{n} w={w} p={args.p} "
        f"hop={args.hop} znorm={args.znorm} "
        f"thresholds={np.round(thr, 3).tolist()}"
    )

    # session facade: the template bank is the database, its envelopes
    # are build-once artifacts shared by every matcher the session mints
    session = Database.build(
        templates,
        SearchConfig(
            w=w,
            p=args.p,
            block=args.block,
            method=args.method,
            znorm=args.znorm,
        ),
        device=device,
    )
    matcher = session.stream(
        threshold=thr,
        hop=args.hop,
        prefilter=not args.no_prefilter,
    )
    t0 = time.perf_counter()
    for lo in range(0, args.samples, args.chunk):
        matcher.push(stream[lo : lo + args.chunk])
        for m in matcher.poll():
            print(
                f"  t={lo + args.chunk:>8d}  match template {m.tid} "
                f"@ {m.start} dist={m.dist:.3f}"
            )
    matcher.flush()
    for m in matcher.poll():
        print(f"  t=   flush  match template {m.tid} @ {m.start} dist={m.dist:.3f}")
    dt = time.perf_counter() - t0

    s = matcher.stats
    total = int(s.n_windows.sum())
    hits = matcher.matches()
    # a detection counts as recovering a plant when it lands within a
    # small fraction of the template length (the best-DTW window can sit
    # a few samples off the plant, especially under z-normalization)
    tol = max(args.hop, n // 16)
    recovered = sum(
        any(m.tid == tid and abs(m.start - pos) <= tol for m in hits)
        for tid, pos, _ in plants
    )
    print(
        f"{args.samples} samples in {dt*1e3:.1f} ms "
        f"({args.samples/dt:,.0f} samples/sec); "
        f"{matcher.windows_evaluated} windows x {s.n_templates} templates"
    )
    print(
        f"pruned before DTW: {100*s.pruned_before_dtw:.1f}% "
        f"(S0 env {int(s.env_pruned.sum())}, lb1 {int(s.lb1_pruned.sum())}, "
        f"lb2 {int(s.lb2_pruned.sum())}, dtw {int(s.full_dtw.sum())} "
        f"of {total} template-window lanes)"
    )
    print(
        f"matches={len(hits)} planted_recovered={recovered}/{len(plants)}"
    )


if __name__ == "__main__":
    main()
