"""Repeat-motion segmentation on a live stream, on the PyTorch port (the
twin of ``examples/motion_segmentation.py``; DESIGN.md §3.5).

The workload of the repeat-motion-segmentation literature: a noisy
sensor signal contains repeated occurrences of known motion templates
(a sine cycle, a gaussian bump); segment the stream by detecting every
occurrence, online.  A ``StreamMatcher`` watches the signal in 512-sample
chunks and reports each occurrence (template id, position, DTW distance)
as soon as its trivial-match-exclusion decision is stable — the printed
segmentation is provably identical to an offline scan of the whole
recording.  Runs on the GPU; ``--device cpu`` runs the plain PyTorch
versions of the kernels.

    PYTHONPATH=src python examples/motion_segmentation_torch.py
    PYTHONPATH=src python examples/motion_segmentation_torch.py --device cpu --samples 3000
"""

import argparse
import time

import numpy as np

from repro_torch.data.synthetic import planted_stream, template_bank
from repro_torch.launch.stream import calibrate_thresholds
from repro_torch.stream import StreamMatcher, windowed_matches

N = 64  # template length
W = 6  # warping half-window
HOP = 2
CHUNK = 512


def main(samples: int = 6000, device=None):
    """Segment ``samples`` samples; returns (segments, the matcher's stats)."""
    rng = np.random.default_rng(42)
    templates = template_bank(N, kinds=("sine", "gaussian"))
    n_plants = max(samples * 5 // 6000, 1)
    stream, plants = planted_stream(rng, samples, templates, n_plants, noise_level=0.05)
    # tight calibration (20% of the median noise-window distance) separates
    # true occurrences (~noise scale) from cross-template look-alikes
    thr = calibrate_thresholds(templates, stream[:2048], W, 2, HOP, False, frac=0.2,
                               device=device)
    print(f"templates: sine + gaussian, length {N}; thresholds {np.round(thr, 2)}")
    print(f"planted occurrences: {[(t, p) for t, p, _ in plants]}")

    matcher = StreamMatcher(templates, W, thr, p=2, hop=HOP, block=64, device=device)
    t0 = time.perf_counter()
    segments = []
    for lo in range(0, samples, CHUNK):
        matcher.push(stream[lo : lo + CHUNK])
        for m in matcher.poll():
            segments.append(m)
            print(
                f"  [{lo + CHUNK:>5d} samples seen] segment: template {m.tid} "
                f"at {m.start}..{m.start + N} (dist {m.dist:.3f})"
            )
    matcher.flush()
    for m in matcher.poll():
        segments.append(m)
        print(f"  [flush] segment: template {m.tid} at {m.start}..{m.start + N} "
              f"(dist {m.dist:.3f})")
    dt = time.perf_counter() - t0

    # every planted occurrence recovered, with the right template, and
    # nothing else detected
    assert len(segments) == len(plants), (segments, plants)
    for (tid, pos, _), m in zip(plants, sorted(segments, key=lambda m: m.start)):
        assert m.tid == tid and abs(m.start - pos) <= HOP, (m, (tid, pos))

    # the streamed segmentation equals the offline windowed scan exactly
    offline, _ = windowed_matches(stream, templates, W, thr, p=2, hop=HOP, device=device)
    assert sorted(segments, key=lambda m: (m.start, m.tid)) == offline

    s = matcher.stats
    print(
        f"segmented {samples} samples in {dt*1e3:.1f} ms "
        f"({samples/dt:,.0f} samples/sec), {len(segments)}/{len(plants)} "
        f"occurrences, {100*s.pruned_before_dtw:.1f}% of window lanes pruned "
        f"before DTW; matches offline scan."
    )
    return segments, s


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=6000)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; 'cpu' runs the plain versions)")
    args = ap.parse_args()
    main(args.samples, args.device)
