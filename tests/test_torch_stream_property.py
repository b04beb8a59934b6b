"""Property tests of repro_torch's StreamState (hypothesis; skips cleanly
when hypothesis is absent).

Drawn series include float32 subnormals.  The port keeps them (ROADMAP.md
queue 3, C): its online deque envelope equals its batch envelope (K1's
plain version) and ``repro.core.envelope.envelope_naive``, and its ring is
``repro.stream.state.StreamState`` bit for bit, for every push chunking.
JAX's CPU ``envelope`` flushes subnormals to 0, so it is not held here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.envelope import envelope_naive  # noqa: E402
from repro.stream.state import StreamState as JStreamState  # noqa: E402
from repro_torch.kernels.envelope.ops import envelope_op  # noqa: E402
from repro_torch.stream.state import (  # noqa: E402
    StreamState,
    prefix_sums,
    window_mean_std_from_prefix,
)

torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny)
values = st.one_of(
    st.floats(-100, 100, allow_nan=False, width=32),
    st.floats(-TINY, TINY, allow_nan=False, allow_subnormal=True, width=32),
)
series = st.lists(values, min_size=2, max_size=80)


@st.composite
def stream_cases(draw):
    xs = np.asarray(draw(series), np.float32)
    w = draw(st.integers(0, 20))
    chunk = draw(st.integers(1, len(xs)))
    return xs, min(w, len(xs) - 1), chunk


def pushed(cls, xs, w, chunk):
    state = cls(capacity=len(xs) + 2 * w + 2, w=w)
    for lo in range(0, len(xs), chunk):
        state.push(xs[lo : lo + chunk])
    return state


@settings(max_examples=60, deadline=None)
@given(stream_cases())
def test_online_envelope_bitmatches_batch_and_repro(case):
    """After pushes in any chunking the deque envelope equals the batch
    envelope and the numpy oracle, and the reference's ring, bit for bit."""
    xs, w, chunk = case
    state = pushed(StreamState, xs, w, chunk)
    u, l = state.envelope_view(0, len(xs))
    un, ln = envelope_naive(xs, w)
    np.testing.assert_array_equal(u, un)
    np.testing.assert_array_equal(l, ln)
    ub, lb = envelope_op(torch.from_numpy(xs)[None], w)
    np.testing.assert_array_equal(u, ub[0].numpy())
    np.testing.assert_array_equal(l, lb[0].numpy())
    ju, jl = pushed(JStreamState, xs, w, chunk).envelope_view(0, len(xs))
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(l, jl)


@settings(max_examples=40, deadline=None)
@given(stream_cases())
def test_rolling_stats_bitmatch_repro_and_prefix(case):
    """Ring-based rolling mean/std equal the offline prefix-sum twin and
    the reference's ring, bit for bit."""
    xs, w, chunk = case
    n = min(len(xs), max(2, w + 1))
    starts = np.arange(0, len(xs) - n + 1, dtype=np.int64)
    state = pushed(StreamState, xs, w, chunk)
    m_on, s_on = state.window_mean_std(starts, n)
    m_off, s_off = window_mean_std_from_prefix(*prefix_sums(xs), starts, n)
    j_m, j_s = pushed(JStreamState, xs, w, chunk).window_mean_std(starts, n)
    for got, want in ((m_on, m_off), (s_on, s_off), (m_on, j_m), (s_on, j_s)):
        np.testing.assert_array_equal(got, want)
