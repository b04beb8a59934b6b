"""The K5 kernel's bit-level oracle, ``dtw_wavefront_plain``, on the CPU.

``repro_torch.kernels.dtw.dtw_wavefront_plain`` repeats the CUDA
kernel's anti-diagonal DP (``csrc/dtw.cu``) and its abandon rule; the
kernel is held bit-equal to it on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here it is held against the port's
``dtw_banded_diag`` (bit-equal), the JAX reference's
``repro.core.dtw.dtw_banded_diag`` and ``repro.kernels.dtw.ref`` oracles
(rtol 3e-4: the reference's finite-p row DP sums in another order), the
float64 O(n^2) oracle (rtol 1e-12 at float64), and, for abandoned lanes,
a float64 full-matrix DP that applies the abandon rule cell by cell
(bit-equal).  All inputs are made from a seed with numpy.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.dtw import dtw_banded_diag as j_dtw_diag  # noqa: E402
from repro.core.dtw import dtw_reference  # noqa: E402
from repro.kernels.dtw.ref import dtw_early_ref, dtw_ref  # noqa: E402
from repro_torch.core.dtw import BIG, dtw_banded_diag  # noqa: E402
from repro_torch.kernels.dtw import dtw_wavefront_plain  # noqa: E402
from repro_torch.kernels.dtw.ops import ABANDON_EVERY  # noqa: E402

torch.set_num_threads(1)

PS = [1, 2, math.inf]
N = 24


def walks(seed, rows, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).cumsum(axis=1).astype(dtype)


def close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0)


def full_matrix(q, c, w, p):
    """Float64 banded DP over the whole (n, n) grid, cells off the band at
    BIG, with the kernel's cell arithmetic (an independent layout)."""
    n = len(q)
    d = np.full((n, n), BIG)
    for i in range(n):
        for j in range(max(0, i - w), min(n, i + w + 1)):
            diff = abs(q[i] - c[j])
            cost = diff * diff if p == 2 else diff
            if i == 0 and j == 0:
                best = 0.0
            else:
                best = min(d[i - 1, j] if i else BIG, d[i, j - 1] if j else BIG,
                           d[i - 1, j - 1] if i and j else BIG)
            d[i, j] = min(max(cost, best) if p == math.inf else cost + best, BIG)
    return d


def abandoned_value(q, c, w, p, bound):
    """The abandon rule on the full matrix: before step s (s % ABANDON_EVERY
    == 0) stop if min(diagonals s-1 and s-2) >= bound, the origin's diag
    predecessor counting as 0; else the exact distance."""
    d = full_matrix(q, c, w, p)
    n = len(q)
    sums = np.add.outer(np.arange(n), np.arange(n))
    for s in range(0, 2 * n - 1, ABANDON_EVERY):
        cells = d[(sums == s - 1) | (sums == s - 2)]
        m = min(cells.min(), BIG) if cells.size else BIG
        if s == 0:
            m = 0.0
        if m >= bound:
            return m
    return d[n - 1, n - 1]


def pair_list(seed, nq, nb, npairs):
    rng = np.random.default_rng(seed)
    return rng.integers(0, nq, npairs), rng.integers(0, nb, npairs)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("w", [0, 3, N - 1])
def test_wavefront_plain_matches_diag_dp_and_jax(p, w):
    qs, xs = walks(1, 3, N), walks(2, 5, N)
    got = dtw_wavefront_plain(torch.as_tensor(qs), torch.as_tensor(xs), w, p).numpy()
    rows_q = torch.as_tensor(np.repeat(qs, 5, axis=0))
    rows_x = torch.as_tensor(np.tile(xs, (3, 1)))
    port = dtw_banded_diag(rows_q, rows_x, w, p, powered=True).numpy().reshape(3, 5)
    np.testing.assert_array_equal(got, port)
    for a in range(3):
        jdiag = [float(j_dtw_diag(jnp.asarray(qs[a]), jnp.asarray(x), w, p, powered=True))
                 for x in xs]
        close(got[a], jdiag, 3e-4)
        close(got[a], np.asarray(dtw_ref(jnp.asarray(qs[a]), jnp.asarray(xs), w, p,
                                         powered=True)), 3e-4)


@pytest.mark.parametrize("p", PS)
def test_wavefront_plain_ragged_pairs(p):
    qs, xs = walks(3, 4, 31), walks(4, 9, 31)
    qi, ci = pair_list(5, 4, 9, 13)
    w = 5
    got = dtw_wavefront_plain(torch.as_tensor(qs), torch.as_tensor(xs), w, p,
                              torch.as_tensor(qi), torch.as_tensor(ci)).numpy()
    dense = dtw_wavefront_plain(torch.as_tensor(qs), torch.as_tensor(xs), w, p).numpy()
    np.testing.assert_array_equal(got, dense[qi, ci])
    want = [float(j_dtw_diag(jnp.asarray(qs[a]), jnp.asarray(xs[b]), w, p, powered=True))
            for a, b in zip(qi, ci)]
    close(got, want, 3e-4)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("w", [0, 4, 39])
def test_wavefront_plain_float64_vs_oracle(p, w):
    qs, xs = walks(6, 2, 40, np.float64), walks(7, 3, 40, np.float64)
    got = dtw_wavefront_plain(torch.as_tensor(qs), torch.as_tensor(xs), w, p).numpy()
    want = [[dtw_reference(a, b, w, p) for b in xs] for a in qs]
    close(got if p != 2 else np.sqrt(got), want, 1e-12)


@pytest.mark.parametrize("p", [1, 2])
def test_wavefront_plain_bounds_vs_early_ref(p):
    n, w = 80, 6
    q, xs = walks(8, 1, n)[0], walks(9, 8, n)
    tq, tx = torch.as_tensor(q[None]), torch.as_tensor(xs)
    full = dtw_wavefront_plain(tq, tx, w, p)[0].numpy()
    bounds = np.where(np.arange(8) % 2 == 0, 0.5 * full, 2 * full).astype(np.float32)
    got = dtw_wavefront_plain(tq, tx, w, p, bounds=torch.as_tensor(bounds[None]))[0].numpy()
    ref = np.asarray(dtw_early_ref(jnp.asarray(q), jnp.asarray(xs), w,
                                   jnp.asarray(bounds), p))
    below = full < bounds
    assert below.any() and (~below).any()
    np.testing.assert_array_equal(got[below], full[below])
    close(got[below], ref[below], 3e-4)
    assert np.all(got[~below] >= bounds[~below])


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("scale", [0.3, 0.8, 1.5])
def test_wavefront_plain_abandon_rule_float64(p, scale):
    """Abandoned lanes return the two-diagonal minimum at the first test
    step where it reaches the bound, bit for bit (float64 full matrix)."""
    n, w = 70, 5
    qs, xs = walks(10, 2, n, np.float64), walks(11, 3, n, np.float64)
    full = dtw_wavefront_plain(torch.as_tensor(qs), torch.as_tensor(xs), w, p).numpy()
    bounds = full * scale
    got = dtw_wavefront_plain(torch.as_tensor(qs), torch.as_tensor(xs), w, p,
                              bounds=torch.as_tensor(bounds)).numpy()
    for a in range(2):
        for b in range(3):
            want = abandoned_value(qs[a], xs[b], w, p, bounds[a, b])
            assert got[a, b] == want, (a, b, got[a, b], want)
            assert got[a, b] >= bounds[a, b] or got[a, b] == full[a, b]


@pytest.mark.parametrize("p", PS)
def test_wavefront_plain_edge_bounds(p):
    """bound <= 0 stops before step 0 and returns 0; bound = BIG never
    stops; n = 1 and w >= n - 1 run."""
    qs, xs = walks(12, 2, 17), walks(13, 3, 17)
    tq, tx = torch.as_tensor(qs), torch.as_tensor(xs)
    full = dtw_wavefront_plain(tq, tx, 40, p)
    zero = dtw_wavefront_plain(tq, tx, 40, p, bounds=torch.zeros(2, 3))
    assert torch.equal(zero, torch.zeros(2, 3))
    big = dtw_wavefront_plain(tq, tx, 40, p, bounds=torch.full((2, 3), BIG))
    assert torch.equal(big, full)
    one = dtw_wavefront_plain(tq[:, :1].contiguous(), tx[:, :1].contiguous(), 0, p)
    np.testing.assert_array_equal(one.numpy(),
                                  np.abs(qs[:, None, 0] - xs[None, :, 0]) ** (2 if p == 2 else 1))
