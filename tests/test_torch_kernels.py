"""The kernel wrappers' plain versions against the JAX kernels (CPU).

On CPU tensors every repro_torch kernel wrapper runs its plain PyTorch
version; these tests hold it against the reference's ``*_ref`` oracle and
its Pallas ``*_op`` in interpret mode, as ``tests/test_kernels.py`` runs
them.  Tolerances as there: envelope and H bit-equal, LB_Keogh rtol 1e-4,
LB_Improved 2e-4, DP 3e-4.

p = inf: the reference's LB kernels compute ``d ** p`` and return inf,
so at p = inf the port's LB_Keogh and LB_Improved are held against
``repro.core.lb`` instead (ROADMAP.md, fault K2).  The CUDA kernels
themselves are checked against these plain versions on the GPU
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import lb as jlb  # noqa: E402
from repro.core.dtw import dtw_reference  # noqa: E402
from repro.core.envelope import envelope_batch as j_envelope_batch  # noqa: E402
from repro.kernels import (  # noqa: E402
    dtw_early_ref,
    dtw_op,
    dtw_ref,
    envelope_op,
    envelope_ref,
    lb_improved_op,
    lb_improved_qbatch_op,
    lb_improved_qbatch_ref,
    lb_improved_ref,
    lb_keogh_op,
    lb_keogh_qbatch_op,
    lb_keogh_qbatch_ref,
    lb_keogh_ref,
)
from repro_torch.kernels import dtw as tdtw  # noqa: E402
from repro_torch.kernels import envelope as tenv  # noqa: E402
from repro_torch.kernels import lb_improved as tli  # noqa: E402
from repro_torch.kernels import lb_keogh as tlk  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.common import p_code  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(4, 32, 3), (8, 100, 10), (5, 47, 46)]  # (B, n, w)
QBATCH = [(3, 10, 64, 7), (2, 13, 47, 46)]  # (Q, B, n, w)


def walks(seed, rows, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


def t(x):
    return torch.as_tensor(np.asarray(x))


def close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


def chunked_envelope(x, w, chunk):
    """Numpy mirror of the CUDA kernel's scheme (csrc/envelope.cu): the row
    padded with w copies of its edge values, cut into chunks; U[i] joins
    the suffix extreme of i's chunk from i, the prefix extreme of b's chunk
    up to b = i + 2w (padded positions) and the chunks between them."""
    n = len(x)
    nck = -(-(n + 2 * w) // chunk)
    xp = np.concatenate([np.full(w, x[0]), x, np.full(nck * chunk - n - w, x[-1])])
    blocks = xp.reshape(nck, chunk)
    out = []
    for acc in (np.maximum, np.minimum):
        suff = acc.accumulate(blocks[:, ::-1], axis=1)[:, ::-1].reshape(-1)
        pref = acc.accumulate(blocks, axis=1).reshape(-1)
        whole = acc.reduce(blocks, axis=1)
        env = np.empty(n, x.dtype)
        for i in range(n):
            ka, kb = i // chunk, (i + 2 * w) // chunk
            assert ka < kb  # every window spans two chunks
            env[i] = acc.reduce([suff[i], pref[i + 2 * w], *whole[ka + 1 : kb]])
        out.append(env)
    return out


@pytest.mark.parametrize("b,n,w", [
    (2, 48, 8),    # n + 2w = 64, a multiple of 32
    (2, 49, 8),    # and not
    (2, 200, 3),   # 2w + 1 <= (n + 2w) / 32: the chunk is cut to 2w - 1
    (2, 200, 40),  # 2w + 1 > it: the chunk is about (n + 2w) / 32
    (3, 1000, 12), (2, 1000, 16), (2, 1000, 17),
    (3, 37, 36), (2, 2, 1), (1, 33, 1),  # w = n - 1; w = 1
])
def test_envelope_plain_vs_ref_at_kernel_chunk_edges(b, n, w):
    """The plain version against the JAX envelope_ref at the chunk edges of
    the kernel's scheme (``envelope_chunk``: odd, at most 2w - 1), and the
    scheme itself (numpy mirror) against both, bit for bit."""
    from repro_torch.kernels.envelope.ops import envelope_chunk

    chunk = envelope_chunk(n, w)
    assert chunk % 2 == 1 and 1 <= chunk <= 2 * w - 1
    xs = walks(2, b, n)
    u, l = tenv.envelope_plain(t(xs), w)
    ur, lr = envelope_ref(jnp.asarray(xs), w)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ur))
    np.testing.assert_array_equal(l.numpy(), np.asarray(lr))
    for row, ru, rl in zip(xs, u.numpy(), l.numpy()):
        cu, cl = chunked_envelope(row, w, chunk)
        np.testing.assert_array_equal(cu, ru)
        np.testing.assert_array_equal(cl, rl)


def test_envelope_mirrors_match_csrc():
    """The wrapper's mirrors of the kernel's rules state the constants of
    ``csrc/envelope.cu`` and of the warp per row's scans it includes
    (``csrc/env_scan.cuh``): the largest batch that runs a block per row
    and the warp per row's chunk rule."""
    import pathlib
    import re

    from repro_torch.kernels.envelope import ops

    csrc = pathlib.Path(ops.__file__).parent.parent.parent / "csrc"
    src = "".join((csrc / name).read_text() for name in ("envelope.cu", "env_scan.cuh"))
    small = re.search(r"constexpr int64_t ENV_SMALL_ROWS = (\d+);", src)
    assert small and int(small.group(1)) == ops.SMALL_ROWS
    assert "const int c = ((n + 2 * w + 31) / 32) | 1;" in src
    assert "return c < 2 * w - 1 ? c : 2 * w - 1;" in src


@pytest.mark.parametrize("b,n,w", SHAPES + [(3, 16, 0), (2, 9, 30)])
def test_envelope_plain_vs_ref_and_op(b, n, w):
    xs = walks(1, b, n)
    u, l = tenv.envelope_op(t(xs), w)
    ur, lr = envelope_ref(jnp.asarray(xs), w)
    uo, lo = envelope_op(jnp.asarray(xs), w, interpret=True)
    for got, want in ((u, ur), (l, lr), (u, uo), (l, lo)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pu, pl = tenv.envelope_plain(t(xs), min(w, n - 1))
    np.testing.assert_array_equal(pu.numpy(), u.numpy())
    np.testing.assert_array_equal(pl.numpy(), l.numpy())


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("b,n,w", SHAPES)
def test_lb_keogh_plain_vs_ref_and_op(b, n, w, p):
    xs, q = walks(2, b, n), walks(3, 1, n)[0]
    ju, jl = j_envelope_batch(jnp.asarray(q)[None], w)
    lb, h = tlk.lb_keogh_op(t(xs), t(ju[0]), t(jl[0]), p)
    lbr, hr = lb_keogh_ref(jnp.asarray(xs), ju[0], jl[0], p)
    lbo, ho = lb_keogh_op(jnp.asarray(xs), ju[0], jl[0], p, interpret=True)
    close(lb, lbr, 1e-4)
    close(lb, lbo, 1e-4)
    np.testing.assert_array_equal(h.numpy(), np.asarray(hr))
    np.testing.assert_array_equal(h.numpy(), np.asarray(ho))


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("nq,b,n,w", QBATCH)
def test_lb_keogh_qbatch_and_pairs(nq, b, n, w, p):
    xs, qs = walks(4, b, n), walks(5, nq, n)
    ju, jl = j_envelope_batch(jnp.asarray(qs), w)
    lb, h = tlk.lb_keogh_qbatch_op(t(xs), t(ju), t(jl), p)
    lbr, hr = lb_keogh_qbatch_ref(jnp.asarray(xs), ju, jl, p)
    lbo, _ = lb_keogh_qbatch_op(jnp.asarray(xs), ju, jl, p, interpret=True)
    close(lb, lbr, 1e-4)
    close(lb, lbo, 1e-4)
    np.testing.assert_array_equal(h.numpy(), np.asarray(hr))
    rng = np.random.default_rng(6)
    qi, ci = t(rng.integers(0, nq, 11)), t(rng.integers(0, b, 11))
    plb, ph = tlk.lb_keogh_pairs_op(t(xs), t(ju), t(jl), qi, ci, p)
    np.testing.assert_array_equal(plb.numpy(), lb.numpy()[qi, ci])
    np.testing.assert_array_equal(ph.numpy(), h.numpy()[qi, ci])


def test_lb_keogh_p_inf_held_against_core():
    """The reference kernel returns inf at p = inf (``d ** inf``); the
    port's max form is held against ``repro.core.lb`` instead."""
    xs, qs = walks(7, 9, 40), walks(8, 3, 40)
    ju, jl = j_envelope_batch(jnp.asarray(qs), 4)
    lb, h = tlk.lb_keogh_qbatch_op(t(xs), t(ju), t(jl), math.inf)
    want = jlb.lb_keogh_powered_qbatch(jnp.asarray(xs), ju, jl, math.inf)
    close(lb, want, 1e-6)
    assert np.isfinite(lb.numpy()).all()
    ref_kernel = np.asarray(lb_keogh_qbatch_op(
        jnp.asarray(xs), ju, jl, math.inf, interpret=True)[0])
    assert np.isinf(ref_kernel[lb.numpy() > 0]).all()  # the reference fault


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("b,n,w", SHAPES)
def test_lb_improved_plain_vs_ref_and_op(b, n, w, p):
    xs, q = walks(9, b, n), walks(10, 1, n)[0]
    ju, jl = j_envelope_batch(jnp.asarray(q)[None], w)
    got = tli.lb_improved_op(t(xs), t(q), t(ju[0]), t(jl[0]), w, p)
    want = lb_improved_ref(jnp.asarray(xs), jnp.asarray(q), ju[0], jl[0], w, p)
    op = lb_improved_op(jnp.asarray(xs), jnp.asarray(q), ju[0], jl[0], w, p,
                        interpret=True)
    close(got, want, 2e-4)
    close(got, op, 2e-4)


@pytest.mark.parametrize("p", [1, 2, math.inf])
@pytest.mark.parametrize("nq,b,n,w", QBATCH)
def test_lb_improved_qbatch_and_pairs(nq, b, n, w, p):
    xs, qs = walks(11, b, n), walks(12, nq, n)
    ju, jl = j_envelope_batch(jnp.asarray(qs), w)
    got = tli.lb_improved_qbatch_op(t(xs), t(qs), t(ju), t(jl), w, p)
    if p == math.inf:  # held against core.lb: the reference op adds inf
        want = jlb.lb_improved_powered_qbatch(
            jnp.asarray(xs), jnp.asarray(qs), ju, jl, w, p)
    else:
        want = lb_improved_qbatch_ref(jnp.asarray(xs), jnp.asarray(qs), ju, jl, w, p)
        op = lb_improved_qbatch_op(jnp.asarray(xs), jnp.asarray(qs), ju, jl, w, p,
                                   interpret=True)
        close(got, op, 2e-4)
    close(got, want, 2e-4)
    _, h = tlk.lb_keogh_qbatch_op(t(xs), t(ju), t(jl), p)
    dense2 = tli.lb_improved_pass2_qbatch_op(h, t(qs), w, p)
    rng = np.random.default_rng(13)
    qi, ci = rng.integers(0, nq, 9), rng.integers(0, b, 9)
    pairs2 = tli.lb_improved_pass2_pairs_op(
        h[t(qi), t(ci)], t(qs), t(qi), w, p)
    np.testing.assert_array_equal(pairs2.numpy(), dense2.numpy()[qi, ci])
    single = tli.lb_improved_pass2_op(h[0], t(qs[0]), w, p)
    np.testing.assert_array_equal(single.numpy(), dense2.numpy()[0])


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("b,n,w", [(4, 32, 3), (5, 47, 46), (3, 40, 0)])
def test_dtw_plain_vs_ref_and_op(b, n, w, p):
    xs, q = walks(14, b, n), walks(15, 1, n)[0]
    got = tdtw.dtw_op(t(q), t(xs), w, p)
    want = dtw_ref(jnp.asarray(q), jnp.asarray(xs), w, p)
    op = dtw_op(jnp.asarray(q), jnp.asarray(xs), w, p, interpret=True)
    close(got, want, 3e-4)
    close(got, op, 3e-4)
    close(got, [dtw_reference(q, x, w, p) for x in xs], 2e-4)


@pytest.mark.parametrize("p", [1, 2])
def test_dtw_abandon_vs_early_ref_and_op(p):
    xs, q = walks(16, 8, 48), walks(17, 1, 48)[0]
    w = 5
    full = tdtw.dtw_op(t(q), t(xs), w, p, powered=True).numpy()
    bounds = np.where(np.arange(8) % 2 == 0, 0.5 * full, 2 * full).astype(np.float32)
    got = tdtw.dtw_op(t(q), t(xs), w, p, powered=True, bounds=t(bounds)).numpy()
    ref = np.asarray(dtw_early_ref(jnp.asarray(q), jnp.asarray(xs), w,
                                   jnp.asarray(bounds), p))
    op = np.asarray(dtw_op(jnp.asarray(q), jnp.asarray(xs), w, p, powered=True,
                           bounds=jnp.asarray(bounds), interpret=True))
    below = full < bounds
    close(got[below], ref[below], 3e-4)
    close(got[below], op[below], 3e-4)
    for v in (got, ref, op):  # abandoned lanes: only >= bound is promised
        assert np.all(v[~below] >= bounds[~below])


@pytest.mark.parametrize("p", [1, 2, math.inf])
def test_dtw_pairs_and_dense_forms(p):
    qs, xs = walks(18, 3, 30), walks(19, 6, 30)
    w = 4
    dense = tdtw.dtw_qbatch_op(t(qs), t(xs), w, p).numpy()
    rng = np.random.default_rng(20)
    qi, ci = rng.integers(0, 3, 7), rng.integers(0, 6, 7)
    pairs = tdtw.dtw_pairs_op(t(qs), t(xs), t(qi), t(ci), w, p).numpy()
    np.testing.assert_array_equal(pairs, dense[qi, ci])
    oracle = [[dtw_reference(a, b, w, p) for b in xs] for a in qs]
    close(dense if p != 2 else np.sqrt(dense), oracle, 2e-4)


def test_cpu_wrappers_never_launch():
    from repro_torch.kernels.block_merge import block_merge_prepare
    from repro_torch.kernels.lb_fused import lb_fused_prepare as lf_prepare
    from repro_torch.kernels.lb_fused import lb_fused_qbatch_op as t_fused
    from repro_torch.kernels.lb_kim import lb_kim_qbatch_op as t_kim

    reset_launch_counts()
    xs = t(walks(21, 4, 20))
    tenv.envelope_op(xs, 3)
    tlk.lb_keogh_qbatch_op(xs, xs[:2], xs[:2], 1)
    tlk.lb_keogh_stream_qbatch_op(xs.reshape(-1), xs[:2], xs[:2], 20, 3, 1)
    tli.lb_improved_pass2_qbatch_op(xs[None], xs[:1], 3, 1)
    tdtw.dtw_qbatch_op(xs[:2], xs, 3, 1)
    t_fused(xs, xs[:2], xs[:2], xs[:2], 3, xs[:2, 0], 1)
    t_kim(xs, xs[:2], None, 1)
    # the device-resident loop's launchers, prepared on CPU tensors
    stage = torch.empty((2, xs.shape[0]), dtype=torch.uint8)
    dvals = torch.empty((2, xs.shape[0]), dtype=xs.dtype)
    top_v = torch.full((2, 3), 1e30, dtype=xs.dtype)
    top_i = torch.full((2, 3), -1, dtype=torch.int64)
    lf_prepare(xs[:2], xs[:2], xs[:2], 3, top_v[:, -1], 1, xs.shape[0], stage)(xs, 3)
    lf_prepare(xs[:2], xs[:2], xs[:2], 3, top_v[:, -1], 1, xs.shape[0], stage,
               kim=True)(xs, 3)
    counters = (torch.zeros((3, 2), dtype=torch.int64), torch.zeros(4, dtype=torch.int64))
    block_merge_prepare(top_v, top_i, *counters, stage, dvals, 16)(0)
    tdtw.dtw_masked_prepare(xs[:2], 3, 1, stage, top_v[:, -1], dvals,
                            merge=(top_v, top_i, *counters, 16))(xs, 20)
    # the channel entries (d = 2 channels of 10 values a row)
    tenv.envelope_op(xs, 3, 2)
    tli.lb_improved_pass2_qbatch_op(xs[None], xs[:1], 3, 1, 2)
    tdtw.dtw_qbatch_op(xs[:2], xs, 3, 1, d=2)
    t_fused(xs, xs[:2], xs[:2], xs[:2], 3, xs[:2, 0], 1, d=2)
    lf_prepare(xs[:2], xs[:2], xs[:2], 3, top_v[:, -1], 1, xs.shape[0], stage, d=2)(xs, 3)
    tdtw.dtw_masked_prepare(xs[:2], 3, 1, stage, top_v[:, -1], dvals,
                            merge=(top_v, top_i, *counters, 16), d=2)(xs, 20)
    tlk.lb_keogh_stream_qbatch_op(xs[:2], xs[:2], xs[:2], 10, 3, 1, d=2)
    assert launch_counts() == {
        "envelope": 0, "lb_keogh": 0, "lb_improved_pass2": 0, "dtw": 0,
        "lb_fused": 0, "lb_kim": 0, "lb_kim_features": 0, "lb_keogh_stream": 0,
        "block_merge": 0, "dtw_merge": 0, "dtw_mv": 0, "dtw_merge_mv": 0,
        "lb_keogh_stream_mv": 0,
    }


def test_p_codes_and_unsupported_p():
    assert (p_code(1), p_code(2), p_code(math.inf)) == (1, 2, 0)
    with pytest.raises(ValueError):
        p_code(3)


def test_cuda_launchers_refuse_cpu_tensors():
    """The launch functions take CUDA tensors only; the wrappers route CPU
    tensors to the plain version instead (no fallback the other way)."""
    from repro_torch.kernels.block_merge import block_merge_launch
    from repro_torch.kernels.lb_kim import lb_kim_features_launch, lb_kim_launch

    xs = t(walks(22, 2, 10))
    stage = torch.full((2, 2), 2, dtype=torch.uint8)
    for launch, args in (
        (tenv.envelope_launch, (xs, 2)),
        (lb_kim_launch, (xs, xs, None, 1)),
        (lb_kim_features_launch, (xs,)),
        (tlk.lb_keogh_launch, (xs, xs, xs, 1)),
        (tli.lb_improved_pass2_launch, (xs[None], xs[:1], 2, 1)),
        (tdtw.dtw_launch, (xs, xs, 2, 1)),
        (tdtw.dtw_merge_launch, (xs, xs, stage, 2, 1, None, xs.clone(), xs[:, :1].clone(),
                                 torch.zeros((2, 1), dtype=torch.int64),
                                 torch.zeros((3, 2), dtype=torch.int64),
                                 torch.zeros(4, dtype=torch.int64), 0, 16)),
        (block_merge_launch, (xs, torch.zeros((2, 10), dtype=torch.int64),
                              torch.zeros((3, 2), dtype=torch.int64),
                              torch.zeros(4, dtype=torch.int64), stage, xs.clone(), 0, 16)),
    ):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch(*args)


@pytest.mark.parametrize("p", [1, 2])
def test_port_oracles_match_reference_oracles(p):
    """The port's ``ref.py`` oracles against the reference's."""
    from repro_torch.kernels.dtw import dtw_early_ref as t_early, dtw_ref as t_dtw
    from repro_torch.kernels.envelope import envelope_ref as t_env
    from repro_torch.kernels.lb_improved import (
        lb_improved_qbatch_ref as t_liq, lb_improved_ref as t_li)
    from repro_torch.kernels.lb_keogh import (
        lb_keogh_qbatch_ref as t_lkq, lb_keogh_ref as t_lk)

    xs, qs = walks(23, 6, 36), walks(24, 2, 36)
    w = 4
    ju, jl = j_envelope_batch(jnp.asarray(qs), w)
    tu, tl = t_env(t(qs), w)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(envelope_ref(jnp.asarray(qs), w)[0]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    close(t_lk(t(xs), tu[0], tl[0], p)[0], lb_keogh_ref(jnp.asarray(xs), ju[0], jl[0], p)[0], 1e-4)
    close(t_lkq(t(xs), tu, tl, p)[0], lb_keogh_qbatch_ref(jnp.asarray(xs), ju, jl, p)[0], 1e-4)
    close(t_li(t(xs), t(qs[0]), tu[0], tl[0], w, p),
          lb_improved_ref(jnp.asarray(xs), jnp.asarray(qs[0]), ju[0], jl[0], w, p), 2e-4)
    close(t_liq(t(xs), t(qs), tu, tl, w, p),
          lb_improved_qbatch_ref(jnp.asarray(xs), jnp.asarray(qs), ju, jl, w, p), 2e-4)
    close(t_dtw(t(qs[0]), t(xs), w, p), dtw_ref(jnp.asarray(qs[0]), jnp.asarray(xs), w, p), 3e-4)
    big = np.full(6, 1e30, np.float32)
    close(t_early(t(qs[0]), t(xs), w, t(big), p),
          dtw_early_ref(jnp.asarray(qs[0]), jnp.asarray(xs), w, jnp.asarray(big), p), 3e-4)
