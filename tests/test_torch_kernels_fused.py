"""The plain versions of the fused LB (K4), LB_Kim (K6) and stream
LB_Keogh (K7) kernels against the JAX kernels, and the host driver's
fused route (CPU).

The JAX side runs its ``*_ref`` oracles and its Pallas ``*_op`` wrappers
in interpret mode at the fallback schedule, as ``tests/test_kernels.py``
runs them.  Tolerances as there: H and masks bit-equal, LB_Keogh and
LB_Kim rtol 1e-4, LB_Improved 2e-4.  At p = inf the reference's LB
kernels compute ``d ** p`` (ROADMAP.md, fault K2), so the stream ops are
held against ``repro.core.lb`` there.  The CUDA kernels are held against
these plain versions on the card (``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import cascade as jcas  # noqa: E402
from repro.core import lb as jlb  # noqa: E402
from repro.core.envelope import envelope_batch as j_envelope_batch  # noqa: E402
from repro.kernels.lb_fused.ops import lb_fused_qbatch_op as j_fused_op  # noqa: E402
from repro.kernels.lb_fused.ref import lb_fused_qbatch_ref as j_fused_ref  # noqa: E402
from repro.kernels.lb_improved.ops import (  # noqa: E402
    lb_improved_stream_qbatch_op as j_improved_stream_op,
)
from repro.kernels.lb_improved.ref import (  # noqa: E402
    lb_improved_stream_qbatch_ref as j_improved_stream_ref,
)
from repro.kernels.lb_keogh.ops import lb_keogh_stream_qbatch_op as j_stream_op  # noqa: E402
from repro.kernels.lb_keogh.ref import lb_keogh_stream_qbatch_ref as j_stream_ref  # noqa: E402
from repro.kernels.lb_keogh.ref import materialize_windows as j_windows  # noqa: E402
from repro.kernels.lb_kim.ops import lb_kim_qbatch_op as j_kim_op  # noqa: E402
from repro.kernels.lb_kim.ref import lb_kim_qbatch_ref as j_kim_ref  # noqa: E402
from repro_torch.core import cascade as tcas  # noqa: E402
from repro_torch.kernels import lb_fused as tf  # noqa: E402
from repro_torch.kernels import lb_improved as tli  # noqa: E402
from repro_torch.kernels import lb_keogh as tlk  # noqa: E402
from repro_torch.kernels import lb_kim as tkim  # noqa: E402

torch.set_num_threads(1)


def walks(seed, rows, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


def t(x):
    return torch.as_tensor(np.array(x))


def stats_key(s):
    return (s.n_candidates, s.full_dtw, s.stage_names, tuple(s.stage_pruned),
            s.blocks_total, s.blocks_lb2, s.blocks_dtw, s.dp_lane_work,
            s.dp_lane_useful)


def close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


# ------------------------------------------------------------ K4 lb_fused


def fused_problem(nq, b, n, w, p, seed=1):
    xs, qs = walks(seed, b, n), walks(seed + 1, nq, n)
    ju, jl = j_envelope_batch(jnp.asarray(qs), w)
    lb1 = np.sort(np.asarray(jlb.lb_keogh_powered_qbatch(jnp.asarray(xs), ju, jl, p)), axis=1)
    # halfway between the two middle values: about half the lanes reach
    # pass 2, and no lane sits within rounding of its bound
    mid = b // 2
    bounds = (0.5 * (lb1[:, mid - 1] + lb1[:, mid])).astype(np.float32)
    bounds[0] = 0.0  # query 0 has no live lane: every tile skips pass 2
    return xs, qs, ju, jl, bounds


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("nq,b,n,w", [(3, 13, 33, 3), (4, 40, 64, 6), (2, 8, 47, 46)])
def test_lb_fused_plain_vs_ref_and_op(nq, b, n, w, p):
    xs, qs, ju, jl, bounds = fused_problem(nq, b, n, w, p)
    lb1, lb = tf.lb_fused_qbatch_op(t(xs), t(qs), t(ju), t(jl), w, t(bounds), p)
    args = (jnp.asarray(xs), jnp.asarray(qs), ju, jl, w, jnp.asarray(bounds))
    r1, r = j_fused_ref(*args, p)
    o1, o = j_fused_op(*args, p, tile_b=8, depth=1, grid="qb", interpret=True)
    for want1, want in ((r1, r), (o1, o)):
        close(lb1, want1, 1e-4)
        dead = np.asarray(want1) >= bounds[:, None]
        np.testing.assert_array_equal(lb1.numpy() >= bounds[:, None], dead)
        close(lb.numpy()[~dead], np.asarray(want)[~dead], 2e-4)
    dead = lb1.numpy() >= bounds[:, None]
    assert dead[0].all() and not dead.all()
    np.testing.assert_array_equal(lb.numpy()[dead], lb1.numpy()[dead])
    # the port's own oracle agrees too
    p1, pl = tf.lb_fused_qbatch_ref(t(xs), t(qs), t(ju), t(jl), w, t(bounds), p)
    close(lb1, p1, 1e-6)
    close(lb, pl, 2e-4)


def test_lb_fused_p_inf_and_mv_raise():
    xs, qs, ju, jl, bounds = fused_problem(2, 5, 20, 2, 1)
    for op, args in (
        (tf.lb_fused_qbatch_op, (t(xs), t(qs), t(ju), t(jl), 2, t(bounds))),
        (j_fused_op, (jnp.asarray(xs), jnp.asarray(qs), ju, jl, 2, jnp.asarray(bounds))),
    ):
        with pytest.raises(ValueError, match="p in"):
            op(*args, math.inf)
    # d = 2 channels of 10 values: the two passes composed, as the
    # reference op composes them (lb1 1e-4, lb 2e-4)
    from repro.mv.envelope import envelope_batch_mv as j_envelope_mv

    mu, ml = j_envelope_mv(jnp.asarray(qs), 2, 2)
    lb1, lb = tf.lb_fused_qbatch_op(t(xs), t(qs), t(mu), t(ml), 2, t(bounds), 1, d=2)
    r1, r = j_fused_op(jnp.asarray(xs), jnp.asarray(qs), mu, ml, 2, jnp.asarray(bounds), 1,
                       interpret=True, d=2)
    close(lb1, r1, 1e-4)
    close(lb, r, 2e-4)
    dead = lb1.numpy() >= bounds[:, None]
    np.testing.assert_array_equal(lb.numpy()[dead], lb1.numpy()[dead])


# -------------------------------------------------------------- K6 lb_kim


@pytest.mark.parametrize("p", [1, 2, math.inf])
@pytest.mark.parametrize("nq,b,n", [(3, 13, 33), (4, 40, 64)])
def test_lb_kim_plain_vs_ref_and_op(nq, b, n, p):
    xs, qs = walks(3, b, n), walks(4, nq, n)
    mask = np.random.default_rng(5).random((nq, b)) < 0.6
    for m in (None, mask, mask.astype(np.float32)):
        got = tkim.lb_kim_qbatch_op(t(xs), t(qs), None if m is None else t(m), p)
        jm = None if m is None else jnp.asarray(m)
        want = j_kim_ref(jnp.asarray(xs), jnp.asarray(qs), jm, p)
        op = j_kim_op(jnp.asarray(xs), jnp.asarray(qs), jm, p, tile_b=8, interpret=True)
        close(got, want, 1e-4)
        close(got, op, 1e-4)
        if m is not None:
            assert (got.numpy()[~mask] == np.float32(1e30)).all()
        mine = tkim.lb_kim_qbatch_ref(t(xs), t(qs), None if m is None else t(m), p)
        assert torch.equal(got, mine)


# ------------------------------------------------------- K7 stream forms


@pytest.mark.parametrize("hop", [1, 3])
@pytest.mark.parametrize("p", [1, 2, math.inf])
def test_stream_ops_vs_ref_and_op(hop, p):
    n, w = 32, 3
    seg = walks(6, 1, 12 * hop + n + 1)[0]
    qs = walks(7, 3, n)
    ju, jl = j_envelope_batch(jnp.asarray(qs), w)
    lb, h = tlk.lb_keogh_stream_qbatch_op(t(seg), t(ju), t(jl), n, hop, p)
    full = tli.lb_improved_stream_qbatch_op(t(seg), t(qs), t(ju), t(jl), n, w, hop, p)
    nb = 13 if hop == 3 else 14  # (L - n) // hop + 1 windows
    assert lb.shape == (3, nb) and h.shape == (3, nb, n)
    wins = jnp.asarray(j_windows(jnp.asarray(seg), n, hop))
    np.testing.assert_array_equal(tlk.materialize_windows(t(seg), n, hop).numpy(),
                                  np.asarray(wins))
    if p == math.inf:  # the reference's stream ops add inf here
        close(lb, jlb.lb_keogh_powered_qbatch(wins, ju, jl, p), 1e-6)
        close(full, jlb.lb_improved_powered_qbatch(wins, jnp.asarray(qs), ju, jl, w, p), 2e-4)
        assert np.isinf(np.asarray(j_stream_op(
            jnp.asarray(seg), ju, jl, n, hop, p, tile_b=8, interpret=True)[0])).any()
    else:
        rlb, rh = j_stream_ref(jnp.asarray(seg), ju, jl, n, hop, p)
        olb, oh = j_stream_op(jnp.asarray(seg), ju, jl, n, hop, p, tile_b=8, interpret=True)
        close(lb, rlb, 1e-4)
        close(lb, olb, 1e-4)
        np.testing.assert_array_equal(h.numpy(), np.asarray(rh))
        np.testing.assert_array_equal(h.numpy(), np.asarray(oh))
        args = (jnp.asarray(seg), jnp.asarray(qs), ju, jl, n, w, hop, p)
        close(full, j_improved_stream_ref(*args), 2e-4)
        close(full, j_improved_stream_op(*args, interpret=True), 2e-4)
    mine = tli.lb_improved_stream_qbatch_ref(t(seg), t(qs), t(ju), t(jl), n, w, hop, p)
    close(full, mine, 2e-4)
    with pytest.raises(ValueError, match="window"):
        tlk.lb_keogh_stream_qbatch_op(t(seg[: n - 1]), t(ju), t(jl), n, hop, p)


# ---------------------------------------------- host driver, fused route


@pytest.mark.parametrize("nq,k", [(8, 5), (1, 1), (8, 1), (1, 5)])
@pytest.mark.parametrize("method", ["lb_improved", "kim_improved"])
def test_host_driver_fused_route_matches_jax(method, nq, k, monkeypatch):
    """nn_search_host runs LB_Keogh -> LB_Improved as one fused op per
    block (on the CPU its plain version; for ``lb_improved`` the prepared
    K4 of the device-resident loop) and still returns the reference's
    top-k and per-stage counters; 200 rows in blocks of 32 leave a
    ragged last block."""
    calls = []
    fused = tcas.lb_fused_qbatch_op
    prepare = tcas.lb_fused_prepare

    def counting(*args, **kwargs):
        calls.append(1)
        return fused(*args, **kwargs)

    def counting_prepare(*args, **kwargs):
        run = prepare(*args, **kwargs)

        def counted(*a):
            calls.append(1)
            return run(*a)

        return counted

    monkeypatch.setattr(tcas, "lb_fused_qbatch_op", counting)
    monkeypatch.setattr(tcas, "lb_fused_prepare", counting_prepare)
    rng = np.random.default_rng(9)
    db = rng.normal(size=(200, 40)).astype(np.float32).cumsum(axis=1)
    qs = rng.normal(size=(nq, 40)).astype(np.float32).cumsum(axis=1)
    q = qs if nq > 1 else qs[0]
    for p in (1, 2):
        calls.clear()
        jres = jcas.nn_search_host(q, db, 4, p, k, 32, method=method)
        tres = tcas.nn_search_host(q, db, 4, p, k, 32, method=method, device="cpu")
        np.testing.assert_array_equal(np.asarray(jres.indices), tres.indices)
        np.testing.assert_allclose(tres.distances, np.asarray(jres.distances), rtol=2e-4)
        for ts, js in zip((tres.stats, *getattr(tres, "per_query", ())),
                          (jres.stats, *getattr(jres, "per_query", ()))):
            assert stats_key(ts) == stats_key(js)
        s = tres.stats
        assert len(calls) == (s.blocks_total if method == "lb_improved" else s.blocks_lb2) > 0
    calls.clear()
    tcas.nn_search_host(q, db, 4, math.inf, k, 32, method=method, device="cpu")
    assert not calls  # p = inf keeps the separate LB_Keogh and LB_Improved stages
