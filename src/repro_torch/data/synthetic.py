"""Synthetic time-series generators used by the paper's experiments.

Paper Section 7 uses Cylinder-Bell-Funnel [Saito 1994], Control Charts
[Pham & Chan 1998], Waveform [Breiman 1998] and Wave+Noise [Gonzalez &
Diez 2000]; Section 12 adds 1000-sample random walks and two shape
data sets (contour-derived time series).  The shape sets are not
redistributable, so ``shape_dataset`` generates centroid-distance
profiles of random smooth closed contours (low-order Fourier series),
which share the shape data's character (smooth, quasi-periodic,
positive) for timing/pruning purposes — noted in EXPERIMENTS.md.

All generators take an explicit ``numpy.random.Generator`` and return
float32 arrays (x: (B, n), y: (B,) labels where classes exist).
"""

from __future__ import annotations

import numpy as np

CBF_LENGTH = 128
CONTROL_LENGTH = 60
WAVEFORM_LENGTH = 21
WAVENOISE_LENGTH = 40


def cylinder_bell_funnel(rng: np.random.Generator, n_per_class: int):
    """3 classes x n_per_class series of length 128 (Saito 1994)."""
    n = CBF_LENGTH

    def base(kind: str):
        a = rng.integers(16, 32 + 1)
        b = a + rng.integers(32, 96 + 1)
        b = min(b, n - 1)
        eta = rng.normal()
        eps = rng.normal(size=n)
        t = np.arange(n)
        chi = ((t >= a) & (t <= b)).astype(np.float64)
        if kind == "cylinder":
            shape = (6 + eta) * chi
        elif kind == "bell":
            shape = (6 + eta) * chi * (t - a) / max(b - a, 1)
        else:  # funnel
            shape = (6 + eta) * chi * (b - t) / max(b - a, 1)
        return shape + eps

    xs, ys = [], []
    for label, kind in enumerate(("cylinder", "bell", "funnel")):
        for _ in range(n_per_class):
            xs.append(base(kind))
            ys.append(label)
    return np.asarray(xs, np.float32), np.asarray(ys, np.int32)


def control_charts(rng: np.random.Generator, n_per_class: int):
    """6 classes x n_per_class series of length 60 (Pham & Chan 1998)."""
    n = CONTROL_LENGTH
    t = np.arange(n, dtype=np.float64)
    xs, ys = [], []
    for label in range(6):
        for _ in range(n_per_class):
            base = 30.0 + 2.0 * rng.standard_normal(n)
            if label == 0:  # normal
                s = base
            elif label == 1:  # cyclic
                amp = rng.uniform(10, 15)
                period = rng.uniform(10, 15)
                s = base + amp * np.sin(2 * np.pi * t / period)
            elif label == 2:  # increasing trend
                s = base + rng.uniform(0.2, 0.5) * t
            elif label == 3:  # decreasing trend
                s = base - rng.uniform(0.2, 0.5) * t
            elif label == 4:  # upward shift
                pos = rng.integers(n // 3, 2 * n // 3)
                s = base + rng.uniform(7.5, 20) * (t >= pos)
            else:  # downward shift
                pos = rng.integers(n // 3, 2 * n // 3)
                s = base - rng.uniform(7.5, 20) * (t >= pos)
            xs.append(s)
            ys.append(label)
    return np.asarray(xs, np.float32), np.asarray(ys, np.int32)


_WAVEFORM_H = None


def _waveform_bases():
    global _WAVEFORM_H
    if _WAVEFORM_H is None:
        t = np.arange(WAVEFORM_LENGTH, dtype=np.float64)
        h1 = np.maximum(6 - np.abs(t - 7), 0)
        h2 = np.maximum(6 - np.abs(t - 15), 0)
        h3 = np.maximum(6 - np.abs(t - 11), 0)
        _WAVEFORM_H = (h1, h2, h3)
    return _WAVEFORM_H


def waveform(rng: np.random.Generator, n_per_class: int):
    """3 classes x n_per_class series of length 21 (Breiman's CART)."""
    h1, h2, h3 = _waveform_bases()
    combos = ((h1, h2), (h1, h3), (h2, h3))
    xs, ys = [], []
    for label, (ha, hb) in enumerate(combos):
        for _ in range(n_per_class):
            u = rng.uniform()
            xs.append(u * ha + (1 - u) * hb + rng.standard_normal(WAVEFORM_LENGTH))
            ys.append(label)
    return np.asarray(xs, np.float32), np.asarray(ys, np.int32)


def wave_noise(rng: np.random.Generator, n_per_class: int):
    """Waveform + 19 pure-noise samples appended -> length 40."""
    xs, ys = waveform(rng, n_per_class)
    noise = rng.standard_normal((xs.shape[0], WAVENOISE_LENGTH - WAVEFORM_LENGTH))
    return np.concatenate([xs, noise.astype(np.float32)], axis=1), ys


def random_walks(rng: np.random.Generator, count: int, length: int = 1000):
    """x_i = x_{i-1} + N(0,1), x_1 = 0 (paper Section 12.1)."""
    steps = rng.standard_normal((count, length)).astype(np.float32)
    steps[:, 0] = 0.0
    return np.cumsum(steps, axis=1)


def white_noise(rng: np.random.Generator, count: int, length: int = 100):
    return rng.standard_normal((count, length)).astype(np.float32)


def shape_dataset(
    rng: np.random.Generator, count: int, length: int = 1024, harmonics: int = 12
):
    """Centroid-distance profiles of random smooth closed contours.

    Stand-in for the paper's (non-redistributable) heterogeneous-shape
    (1024-sample) and arrowhead (251-sample) sets: positive, smooth,
    quasi-periodic series with matched lengths.
    """
    t = np.linspace(0, 2 * np.pi, length, endpoint=False)
    ks = np.arange(1, harmonics + 1)
    amp = rng.uniform(0.0, 1.0, size=(count, harmonics)) / ks[None, :]
    phase = rng.uniform(0, 2 * np.pi, size=(count, harmonics))
    base = rng.uniform(2.0, 4.0, size=(count, 1))
    prof = base + np.einsum(
        "bh,bht->bt", amp, np.sin(ks[None, :, None] * t[None, None, :] + phase[..., None])
    )
    return prof.astype(np.float32)


def template_bank(length: int, kinds=("sine", "gaussian")) -> np.ndarray:
    """Deterministic (Q, length) motion templates — the shapes of the
    repeat-motion-segmentation workload (sine cycle, gaussian bump, and
    their variants)."""
    t = np.arange(length, dtype=np.float64)
    mu = (length - 1) / 2.0
    sig = (length - mu) / 2.5
    shapes = {
        "sine": np.sin(2 * np.pi * t / length),
        "cosine": np.cos(2 * np.pi * t / length),
        "gaussian": np.exp(-0.5 * ((t - mu) / sig) ** 2),
        "gaussian_inverted": 1.0 - np.exp(-0.5 * ((t - mu) / sig) ** 2),
    }
    unknown = set(kinds) - set(shapes)
    if unknown:
        raise ValueError(f"unknown template kinds {sorted(unknown)}")
    return np.stack([shapes[k] for k in kinds]).astype(np.float32)


def planted_stream(
    rng: np.random.Generator,
    length: int,
    templates: np.ndarray,
    n_plants: int,
    noise_level: float = 0.05,
    amp_range: tuple[float, float] = (0.8, 1.2),
):
    """Noise stream with non-overlapping template occurrences planted in.

    Returns ``(stream (length,), plants)`` where ``plants`` is a list of
    ``(template_id, position, amplitude)``; occurrences are separated by
    at least one template length so each is its own ground-truth event.
    """
    templates = np.atleast_2d(np.asarray(templates, np.float32))
    nq, n = templates.shape
    stream = (noise_level * rng.standard_normal(length)).astype(np.float32)
    slots = length // (2 * n) if length >= 2 * n else 0
    if n_plants > slots:
        raise ValueError(
            f"{n_plants} plants of length {n} do not fit in {length} "
            f"samples with non-overlap spacing ({slots} slots)"
        )
    chosen = rng.choice(slots, size=n_plants, replace=False)
    plants = []
    for slot in sorted(chosen):
        jitter = int(rng.integers(0, n // 2 + 1))
        pos = slot * 2 * n + jitter
        tid = int(rng.integers(0, nq))
        amp = float(rng.uniform(*amp_range))
        stream[pos : pos + n] += amp * templates[tid]
        plants.append((tid, pos, amp))
    return stream, plants


DATASETS = {
    "cylinder_bell_funnel": (cylinder_bell_funnel, 3),
    "control_charts": (control_charts, 6),
    "waveform": (waveform, 3),
    "wave_noise": (wave_noise, 3),
}
