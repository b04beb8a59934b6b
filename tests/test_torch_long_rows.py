"""Long rows: every length the reference runs also launches in the port (CPU).

The CUDA kernels keep rows in a block's shared memory where they fit and
take a long-row path by shape where they do not (``csrc/env_scan.cuh``,
``csrc/lb_fused.cu``, ``csrc/dtw.cu``).  On the CPU no kernel runs, so
these tests check what surrounds them: the wrappers' mirrors of the
launchers' path rules against the ``csrc`` text, K4's schedule at the
lengths where its shared-memory form used to refuse, and the plain
versions against the JAX kernels in interpret mode at a length past K3's
former float32 ceiling (n = 4,864 with w = n - 1).  Tolerances as in
``tests/test_kernels.py``: envelope and H bit-equal, LB_Keogh rtol 1e-4,
LB_Improved 2e-4.  The kernels' long-row paths are held against these
plain versions on the card (``tests/test_torch_cuda.py -k long``).
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import lb_fused as tf  # noqa: E402
from repro_torch.kernels.lb_fused.ops import _schedule, fused_long  # noqa: E402
from repro_torch.kernels.tuning import KernelConfig, TuneTable, use_table  # noqa: E402

CSRC = pathlib.Path(common.__file__).resolve().parent.parent / "csrc"

#: (n, itemsize): the long-row checks' float32 and float64 lengths
LONG = [(12_288, 4), (6_144, 8)]


def walks(seed, rows, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("band", ["n//10", "n-1"])
@pytest.mark.parametrize("n,itemsize", LONG)
def test_lb_fused_schedule_resolves_long_rows(n, itemsize, band, explicit):
    """K4's schedule at lengths whose one warp's buffers overflow shared
    memory: the long-row path at any tile, resolved or explicit, never
    ``NotRunnable``."""
    w = n // 10 if band == "n//10" else n - 1
    assert fused_long(n, w, "qb", itemsize) and fused_long(n, w, "bq", itemsize)
    with use_table(TuneTable.with_defaults()):
        tile_b, grid = _schedule(32, n, w, itemsize, 32 if explicit else None, None, None)
    assert 1 <= tile_b <= 32 and grid in ("qb", "bq")
    if explicit:
        assert tile_b == 32
    for g in ("qb", "bq"):
        assert _schedule(32, n, w, itemsize, 1, 1, g) == (1, g)


def test_lb_fused_schedule_keeps_its_refusals_below_the_long_path():
    """Where one warp fits in shared memory an explicit tile that does not
    fit still raises, and a resolved one is halved until it fits."""
    n, w = 4000, 400
    assert not fused_long(n, w, "qb", 4)
    with pytest.raises(common.NotRunnable):
        _schedule(32, n, w, 4, 32, 1, "qb")
    table = TuneTable(entries={("lb_fused", "cuda", "*"): KernelConfig(tile_b=32)})
    with use_table(table):
        tile_b, _ = _schedule(32, n, w, 4, None, None, None)
    assert tf.fused_smem_bytes(n, w, tile_b, "qb", 4) <= common.SMEM_LIMIT_BYTES
    assert tf.fused_smem_bytes(n, w, 2 * tile_b, "qb", 4) > common.SMEM_LIMIT_BYTES


def test_long_path_mirrors_match_csrc():
    """The Python mirrors of the launchers' path rules state the ``csrc``
    rules: the shared-memory limit every launcher holds its buffers to,
    K4's per-warp buffers and its long-row test."""
    common_cuh = (CSRC / "common.cuh").read_text()
    limit = re.search(r"constexpr size_t SMEM_LIMIT = (\d+);", common_cuh)
    assert limit and int(limit.group(1)) == common.SMEM_LIMIT_BYTES
    fused = (CSRC / "lb_fused.cu").read_text()
    assert "return (size_t)n * (bq ? 2 : 1) + 4 * (size_t)(n + 2 * w);" in fused
    assert "return sizeof(T) * fused_warp_elems(n, w, bq) > SMEM_LIMIT;" in fused
    # fused_smem_bytes is that count times the tile and the item size
    for n, w, bq in ((1000, 100, False), (257, 40, True)):
        elems = n * (2 if bq else 1) + 4 * (n + 2 * w)
        assert tf.fused_smem_bytes(n, w, 3, "bq" if bq else "qb", 8) == 8 * 3 * elems
    # the first lengths at which one warp overflows: float32 and float64,
    # w = n // 10 and w = n - 1
    for itemsize, band, want in ((4, 10, 10_020), (4, 0, 4_471), (8, 10, 5_010),
                                 (8, 0, 2_236)):
        def band_of(n):
            return n // band if band else n - 1

        first = next(n for n in range(2, 20_000) if fused_long(n, band_of(n), "qb", itemsize))
        assert first == want
        assert not fused_long(first - 1, band_of(first - 1), "qb", itemsize)


# ------------------------------------------------------------ the plain versions

N_LONG, W_LONG = 4864, 4863  # past K3's former float32 ceiling at w = n - 1


@pytest.fixture(scope="module")
def jax_kernels():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.envelope import envelope_batch
    from repro.kernels import envelope_op, lb_keogh_op
    from repro.kernels.lb_improved.ops import lb_improved_pass2_op

    return jnp, envelope_batch, envelope_op, lb_keogh_op, lb_improved_pass2_op


def test_envelope_plain_long_rows_vs_jax_op(jax_kernels):
    from repro_torch.kernels.envelope.ops import envelope_op as t_envelope_op

    jnp, _, envelope_op, _, _ = jax_kernels
    xs = walks(20, 3, N_LONG)
    u, l = t_envelope_op(torch.as_tensor(xs), W_LONG)
    uo, lo = envelope_op(jnp.asarray(xs), W_LONG, interpret=True)
    np.testing.assert_array_equal(u.numpy(), np.asarray(uo))
    np.testing.assert_array_equal(l.numpy(), np.asarray(lo))


@pytest.mark.parametrize("p", [1, 2])
def test_lb_keogh_plain_long_rows_vs_jax_op(jax_kernels, p):
    from repro_torch.kernels.lb_keogh.ops import lb_keogh_op as t_lb_keogh_op

    jnp, envelope_batch, _, lb_keogh_op, _ = jax_kernels
    xs, q = walks(21, 3, N_LONG), walks(22, 1, N_LONG)
    ju, jl = envelope_batch(jnp.asarray(q), W_LONG)
    lb, h = t_lb_keogh_op(torch.as_tensor(xs), torch.as_tensor(np.array(ju[0])),
                          torch.as_tensor(np.array(jl[0])), p)
    lbo, ho = lb_keogh_op(jnp.asarray(xs), ju[0], jl[0], p, interpret=True)
    np.testing.assert_allclose(lb.numpy(), np.asarray(lbo), rtol=1e-4, atol=0)
    np.testing.assert_array_equal(h.numpy(), np.asarray(ho))


@pytest.mark.parametrize("p", [1, 2])
def test_lb_improved_pass2_plain_long_rows_vs_jax_op(jax_kernels, p):
    from repro_torch.kernels.lb_improved.ops import lb_improved_pass2_op as t_pass2_op

    jnp, _, _, _, lb_improved_pass2_op = jax_kernels
    h, q = walks(23, 3, N_LONG), walks(24, 1, N_LONG)[0]
    got = t_pass2_op(torch.as_tensor(h), torch.as_tensor(q), W_LONG, p)
    want = lb_improved_pass2_op(jnp.asarray(h), jnp.asarray(q), W_LONG, p, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=0)
    assert (got.numpy() > 0).all()
