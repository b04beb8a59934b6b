"""repro_torch's numeric core against its repro.core twins (CPU).

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch port.  Tolerances: envelopes and projections bit-equal (max,
min and clip are exact); LB sums rtol 1e-4 (summation order differs);
DTW rtol 3e-4 against the JAX DP and 2e-4 against the float64 oracle.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import dtw as jdtw  # noqa: E402
from repro.core import lb as jlb  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import dtw as tdtw  # noqa: E402
from repro_torch.core import envelope as tenv  # noqa: E402
from repro_torch.core import lb as tlb  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

# repro.core re-exports the function envelope over the module's name
jenv = importlib.import_module("repro.core.envelope")

torch.set_num_threads(1)

PS = [1, 2, math.inf]
SHAPES = [(6, 32, 3), (5, 47, 46), (4, 64, 6)]  # (rows, n, w)


def walks(seed, rows, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


def t(x):
    return torch.as_tensor(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


@pytest.mark.parametrize("rows,n,w", SHAPES + [(3, 10, 0), (2, 12, 50)])
def test_envelope_batch_bit_equal(rows, n, w):
    xs = walks(1, rows, n)
    tu, tl = tenv.envelope_batch(t(xs), w)
    ju, jl = jenv.envelope_batch(j(xs), w)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    nu, nl = tenv.envelope_naive(xs[0], w)
    np.testing.assert_array_equal(tu[0].numpy(), nu)
    np.testing.assert_array_equal(tl[0].numpy(), nl)
    u1, l1 = tenv.envelope(t(xs[0]), w)
    np.testing.assert_array_equal(u1.numpy(), nu)
    np.testing.assert_array_equal(l1.numpy(), nl)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("rows,n,w", SHAPES)
def test_dtw_against_jax_and_oracle(rows, n, w, p):
    xs, ys = walks(2, rows, n), walks(3, rows, n)
    q = xs[0]
    got = tdtw.dtw_batch(t(q), t(ys), w, p)
    want = jdtw.dtw_batch(j(q), j(ys), w, p)
    close(got, want, 3e-4)
    oracle = [jdtw.dtw_reference(q, y, w, p) for y in ys]
    close(got, oracle, 2e-4)
    np.testing.assert_allclose(
        tdtw.dtw_reference(q, ys[1], w, p), oracle[1], rtol=0, atol=0
    )
    # the anti-diagonal form computes the same DP for every p
    close(tdtw.dtw_banded_diag(t(q)[None], t(ys), w, p), want, 3e-4)
    qq = tdtw.dtw_qbatch(t(xs[:2]), t(ys), w, p, powered=True)
    close(qq, jdtw.dtw_qbatch(j(xs[:2]), j(ys), w, p, powered=True), 3e-4)


@pytest.mark.parametrize("p", [1, 2])
def test_dtw_banded_early_against_jax(p):
    xs, ys = walks(4, 8, 40), walks(5, 8, 40)
    full = np.asarray(jdtw.dtw_qbatch(j(xs[:1]), j(ys), 5, p, powered=True))[0]
    bounds = np.where(np.arange(8) % 2 == 0, 0.5 * full, 2.0 * full).astype(np.float32)
    got = tdtw.dtw_banded_early(t(xs[0])[None], t(ys), 5, t(bounds), p).numpy()
    want = np.asarray(
        [jdtw.dtw_banded_early(j(xs[0]), j(y), 5, b, p) for y, b in zip(ys, bounds)]
    )
    below = full < bounds
    close(got[below], want[below], 3e-4)
    assert np.all(got[~below] >= bounds[~below])
    assert np.all(want[~below] >= bounds[~below])
    one = tdtw.dtw_banded_early(t(xs[0]), t(ys[0]), 5, float(bounds[0]), p)
    assert one.ndim == 0


def test_dtw_finish_cost_and_errors():
    x = t(np.float32([3.0, 4.0]))
    np.testing.assert_allclose(tdtw.finish_cost(x * x, 2).numpy(), [3.0, 4.0])
    assert np.isclose(tdtw.finish_cost(np.float64(9.0), 2), 3.0)
    with pytest.raises(ValueError):
        tdtw.dtw_banded(x, x, 1, math.inf)
    with pytest.raises(ValueError):
        tdtw.dtw_banded(x, t(np.zeros(3, np.float32)), 1, 1)


@pytest.mark.parametrize("p", PS)
def test_lb_keogh_and_improved_against_jax(p):
    cs, qs = walks(6, 9, 48), walks(7, 3, 48)
    w = 5
    ju, jl = jenv.envelope_batch(j(qs), w)
    tu, tl = tenv.envelope_batch(t(qs), w)
    close(tlb.lb_keogh_powered_qbatch(t(cs), tu, tl, p),
          jlb.lb_keogh_powered_qbatch(j(cs), ju, jl, p), 1e-4)
    close(tlb.lb_improved_powered_qbatch(t(cs), t(qs), tu, tl, w, p),
          jlb.lb_improved_powered_qbatch(j(cs), j(qs), ju, jl, w, p), 1e-4)
    close(tlb.lb_improved_powered_batch(t(cs), t(qs[0]), tu[0], tl[0], w, p),
          jlb.lb_improved_powered_batch(j(cs), j(qs[0]), ju[0], jl[0], w, p), 1e-4)
    close(tlb.lb_improved(t(cs[0]), t(qs[0]), w, p),
          jlb.lb_improved(j(cs[0]), j(qs[0]), w, p), 1e-4)
    close(tlb.lb_keogh(t(cs[1]), tu[1], tl[1], p),
          jlb.lb_keogh(j(cs[1]), ju[1], jl[1], p), 1e-4)
    np.testing.assert_array_equal(
        tlb.project(t(cs), tu[0], tl[0]).numpy(),
        np.asarray(jlb.project(j(cs), ju[0], jl[0])),
    )


@pytest.mark.parametrize("p", PS)
def test_lb_kim_and_webb_against_jax(p):
    cs, qs = walks(8, 7, 40), walks(9, 4, 40)
    w = 4
    ju, jl = jenv.envelope_batch(j(qs), w)
    tu, tl = tenv.envelope_batch(t(qs), w)
    close(tlb.lb_kim_powered_qbatch(t(cs), t(qs), p),
          jlb.lb_kim_powered_qbatch(j(cs), j(qs), p), 1e-6)
    close(tlb.lb_kim(t(cs[0]), t(qs[0]), p), jlb.lb_kim(j(cs[0]), j(qs[0]), p), 1e-6)
    close(tlb.lb_webb_powered_qbatch(t(cs), t(qs), tu, tl, w, p),
          jlb.lb_webb_powered_qbatch(j(cs), j(qs), ju, jl, w, p), 1e-4)
    close(tlb.lb_webb(t(cs[2]), t(qs[1]), w, p),
          jlb.lb_webb(j(cs[2]), j(qs[1]), w, p), 1e-4)
    tul, tlu = tlb.envelope_of_envelopes(tu, tl, w)
    jul, jlu = jlb.envelope_of_envelopes(ju, jl, w)
    np.testing.assert_array_equal(tul.numpy(), np.asarray(jul))
    np.testing.assert_array_equal(tlu.numpy(), np.asarray(jlu))


@pytest.mark.parametrize("p", PS)
def test_bounds_below_dtw(p):
    """Every ported bound lower-bounds the ported DTW (soundness)."""
    cs, qs = walks(10, 12, 32), walks(11, 3, 32)
    w = 3
    tu, tl = tenv.envelope_batch(t(qs), w)
    d = tdtw.dtw_qbatch(t(qs), t(cs), w, p, powered=True)
    slack = 1 + 1e-5
    for lbv in (
        tlb.lb_kim_powered_qbatch(t(cs), t(qs), p),
        tlb.lb_keogh_powered_qbatch(t(cs), tu, tl, p),
        tlb.lb_improved_powered_qbatch(t(cs), t(qs), tu, tl, w, p),
        tlb.lb_webb_powered_qbatch(t(cs), t(qs), tu, tl, w, p),
    ):
        assert bool((lbv <= d * slack).all())


def test_synthetic_generators_match_reference():
    for name in ("random_walks", "white_noise", "shape_dataset"):
        got = getattr(tsyn, name)(np.random.default_rng(3), 4, 50)
        want = getattr(jsyn, name)(np.random.default_rng(3), 4, 50)
        np.testing.assert_array_equal(got, want)
    for name, (fn, _) in tsyn.DATASETS.items():
        gx, gy = fn(np.random.default_rng(4), 2)
        wx, wy = jsyn.DATASETS[name][0](np.random.default_rng(4), 2)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
