"""repro_torch's multivariate streaming and serving against repro (CPU).

A d-channel stream (d in {2, 3}) goes through both packages'
``StreamMatcher`` in chunk splits that cross block edges, and through
``windowed_matches``: the same matches ((tid, start) pairs, distances
within rtol 2e-4: the port's float32 DP is not the reference's to the
bit), every ``StreamStats`` field equal (S0 is the reference's numpy on
the host), and the naive oracle of ``tests/test_mv.py`` (a float64
``dtw_reference_mv`` per window, then ``greedy_suppress``).  Without
z-normalization S1 is K7's channel entry over the block's (d, span)
segment, here its plain version, which is held bit-equal to K2's plain
version on the gathered (B, d*n) tile and within 1e-4 of the
reference's ``lb_keogh_qbatch_ref`` there.  ``Database.stream`` and
``QueryEngine`` run over d-channel sessions as the reference's do.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import stream as jstream  # noqa: E402
from repro.api import Database as JDatabase  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro.kernels.lb_keogh.ref import lb_keogh_qbatch_ref  # noqa: E402
from repro.mv.dtw import dtw_reference_mv  # noqa: E402
from repro.serve import QueryEngine as JQueryEngine  # noqa: E402
from repro.stream.state import STD_EPS  # noqa: E402
from repro_torch import stream as tstream  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.kernels.lb_keogh.ops import (  # noqa: E402
    lb_keogh_plain,
    lb_keogh_stream_plain,
    lb_keogh_stream_qbatch_op,
)
from repro_torch.serve import QueryEngine  # noqa: E402

torch.set_num_threads(1)

P_VALUES = [1, 2, math.inf]
CHUNKS = (37, 61, 113, 50)  # odd splits that cross block edges
N_LEN, L_STREAM, HOP, W = 16, 220, 2, 3

STAT_FIELDS = ("n_windows", "env_pruned", "stage_pruned", "full_dtw", "matched")
BATCH_FIELDS = ("blocks_total", "blocks_lb2", "blocks_dtw", "dp_lane_work",
                "dp_lane_useful")


def assert_same_matches(got, want):
    assert [(m.tid, m.start) for m in got] == [(m.tid, m.start) for m in want]
    np.testing.assert_allclose([m.dist for m in got], [m.dist for m in want],
                               rtol=2e-4, atol=1e-6)


def assert_same_stats(got, want):
    assert got.stage_names == want.stage_names
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in BATCH_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def mv_stream(d, seed=15):
    """``tests/test_mv.py``'s stream: a (L, d) random walk, a template cut
    from it at 60 and a random-walk template."""
    rng = np.random.default_rng(seed)
    stream = np.cumsum(rng.normal(size=(L_STREAM, d)).astype(np.float32),
                       axis=0).astype(np.float32)
    tpl = stream[60 : 60 + N_LEN].copy()
    templates = np.stack(
        [tpl, np.cumsum(rng.normal(size=(N_LEN, d)), axis=0).astype(np.float32)]
    )
    return stream, templates


def oracle_matches(stream, templates, w, thr, p, hop, znorm):
    """``tests/test_mv.py``'s oracle: the float64 ``dtw_reference_mv`` of
    every (template, window), per-channel z-normalization, the threshold
    and the offline greedy exclusion."""
    n, d = templates.shape[1], templates.shape[2]
    tq = templates.astype(np.float32)
    if znorm:
        tq = np.stack([np.stack([jstream.znorm_series(t[:, c]) for c in range(d)], axis=1)
                       for t in tq])
    hits = []
    for s in range(0, stream.shape[0] - n + 1, hop):
        win = stream[s : s + n].astype(np.float32)
        if znorm:
            cols = []
            for c in range(d):
                x = stream[s : s + n, c].astype(np.float64)
                mean = x.sum() / n
                std = max(math.sqrt(max(x @ x / n - mean * mean, 0.0)), STD_EPS)
                cols.append(((win[:, c].astype(np.float64) - mean) / std).astype(np.float32))
            win = np.stack(cols, axis=1)
        for qi in range(tq.shape[0]):
            dist = float(dtw_reference_mv(tq[qi], win, w, p))
            if dist <= thr:
                hits.append(jstream.Match(qi, s, dist))
    return jstream.greedy_suppress(hits, n)


# --------------------------------------------------------------- matcher


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
@pytest.mark.parametrize("p", P_VALUES, ids=["p1", "p2", "pinf"])
@pytest.mark.parametrize("d", [2, 3])
def test_mv_matcher_matches_repro_and_oracle(d, p, znorm):
    stream, templates = mv_stream(d)
    thr = 4.0 if znorm else 6.0
    kw = dict(p=p, hop=HOP, znorm=znorm, block=16, d=d)
    tm = tstream.StreamMatcher(templates, W, thr, device="cpu", **kw)
    jm = jstream.StreamMatcher(templates, W, thr, **kw)
    i = 0
    for sz in CHUNKS:
        for m in (tm, jm):
            m.push(stream[i : i + sz])
        i += sz
    for m in (tm, jm):
        m.flush()
    got = tm.matches()
    assert len(got) > 0
    assert_same_matches(got, jm.matches())
    assert_same_stats(tm.stats, jm.stats)
    assert_same_matches(got, oracle_matches(stream, templates, W, thr, p, HOP, znorm))
    st = tm.stats
    np.testing.assert_array_equal(st.env_pruned + st.stage_pruned.sum(axis=0) + st.full_dtw,
                                  st.n_windows)
    # the offline twin over the whole array, flat interleaved samples too
    off, off_stats = tstream.windowed_matches(stream, templates, W, thr, device="cpu", **kw)
    assert [(h.tid, h.start, h.dist) for h in off] == [(h.tid, h.start, h.dist) for h in got]
    joff, joff_stats = jstream.windowed_matches(stream, templates, W, thr, **kw)
    assert_same_stats(off_stats, joff_stats)
    flat, _ = tstream.windowed_matches(stream.reshape(-1), templates, W, thr, device="cpu",
                                       **kw)
    assert flat == off


@pytest.mark.parametrize("d", [2, 3])
def test_mv_matcher_polls_the_offline_set(d):
    """Matches polled after each 29-row chunk, in a ring of three block
    spans, add up to the offline set, which holds both plants."""
    rng = np.random.default_rng(40 + d)
    stream = np.cumsum(rng.normal(size=(600, d)), axis=0).astype(np.float32)
    templates = np.stack([stream[99:123], stream[399:423]])
    off, _ = tstream.windowed_matches(stream, templates, 4, 5.0, p=2, hop=3, block=8, d=d,
                                      device="cpu")
    m = tstream.StreamMatcher(templates, 4, 5.0, p=2, hop=3, block=8, d=d,
                              capacity=3 * ((8 - 1) * 3 + 24), device="cpu")
    polled = []
    for lo in range(0, stream.shape[0], 29):
        polled += m.feed(stream[lo : lo + 29])
    m.flush()
    polled += m.poll()
    assert sorted(polled, key=lambda h: (h.start, h.tid)) == off == m.matches()
    assert {(0, 99), (1, 399)} <= {(h.tid, h.start) for h in off}


# ------------------------------------------------------------- K7c plain


@pytest.mark.parametrize("hop", [1, 3])
@pytest.mark.parametrize("p", P_VALUES, ids=["p1", "p2", "pinf"])
@pytest.mark.parametrize("d", [2, 3])
def test_stream_plain_channels_equal_k2_on_the_tile(d, p, hop):
    """K7c's plain version on a (d, L) segment is K2's plain version on
    the windows gathered in numpy (bit-equal, lb and H), and within 1e-4
    of the reference's ``lb_keogh_qbatch_ref`` on that tile."""
    rng = np.random.default_rng(7 + d)
    n, nq, length = 13, 3, 61
    seg = rng.normal(size=(d, length)).cumsum(axis=1).astype(np.float32)
    qs = rng.normal(size=(nq, d * n)).astype(np.float32)
    upper, lower = qs + 0.5, qs - 0.5
    nb = (length - n) // hop + 1
    tile = np.stack([np.concatenate([seg[c, b * hop : b * hop + n] for c in range(d)])
                     for b in range(nb)])
    lb, h = lb_keogh_stream_plain(torch.as_tensor(seg), torch.as_tensor(upper),
                                  torch.as_tensor(lower), n, hop, p, d=d)
    assert lb.shape == (nq, nb) and h.shape == (nq, nb, d * n)
    klb, kh = lb_keogh_plain(torch.as_tensor(tile), torch.as_tensor(upper),
                             torch.as_tensor(lower), p)
    assert torch.equal(lb, klb) and torch.equal(h, kh)
    op = lb_keogh_stream_qbatch_op(torch.as_tensor(seg), torch.as_tensor(upper),
                                   torch.as_tensor(lower), n, hop, p, d=d)
    assert torch.equal(op[0], lb) and torch.equal(op[1], h)
    jlb, jh = lb_keogh_qbatch_ref(tile, upper, lower, p)
    np.testing.assert_allclose(lb.numpy(), np.asarray(jlb), rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6)


def test_stream_plain_channel_shape_errors():
    seg = torch.zeros((3, 40))
    env = torch.zeros((1, 30))
    with pytest.raises(ValueError, match=r"\(d, L\)"):
        lb_keogh_stream_plain(seg.reshape(-1), env, env, 10, 1, 1, d=3)
    with pytest.raises(ValueError, match=r"\(d, L\)"):
        lb_keogh_stream_plain(seg[:2], env, env, 10, 1, 1, d=3)
    with pytest.raises(ValueError, match="holds no"):
        lb_keogh_stream_plain(seg[:, :9], env, env, 10, 1, 1, d=3)


# ------------------------------------------------------- session and engine


def mv_rows(seed, rows=12, n=N_LEN, d=3):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(rows, n, d)), axis=1).astype(np.float32)


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_mv_database_stream_matches_repro(znorm):
    """``db.stream`` on a d-channel session in both packages: the rows as
    the template bank with the build envelopes reused, explicit (Q, n, d)
    and (n, d) templates with their own; the same matches and stats."""
    x = mv_rows(30)
    cfg = dict(w=W, p=2, block=8, znorm=znorm)
    tdb = Database.build(x, SearchConfig(**cfg), device="cpu")
    jdb = JDatabase.build(x, JConfig(**cfg))
    rng = np.random.default_rng(31)
    stream = np.cumsum(rng.normal(size=(180, 3)), axis=0).astype(np.float32)
    stream[50 : 50 + N_LEN] = x[5] + 0.01
    thr = 3.0 if znorm else 2.0
    tm, jm = tdb.stream(threshold=thr, hop=2), jdb.stream(threshold=thr, hop=2)
    assert tm.d == 3 and tm.scanner._upper is tdb._upper and tm.scanner._lower is tdb._lower
    for templates in (None, x[:4], x[5]):
        tm = tdb.stream(templates, threshold=thr, hop=2)
        jm = jdb.stream(templates, threshold=thr, hop=2)
        if templates is not None:
            assert tm.scanner._upper is not tdb._upper
        for m in (tm, jm):
            m.push(stream[:77])
            m.push(stream[77:].reshape(-1))  # flat interleaved samples
            m.flush()
        assert_same_matches(tm.matches(), jm.matches())
        assert_same_stats(tm.stats, jm.stats)
        if templates is None:
            assert (5, 50) in [(h.tid, h.start) for h in tm.matches()]


def test_mv_database_stream_finds_planted_template():
    """``tests/test_mv.py``'s planted template: a session row planted in a
    d-channel stream is found where it was put."""
    x = mv_rows(16, rows=24, n=20)
    sess = Database.build(x, SearchConfig(w=W, p=1, znorm=True, block=8), device="cpu")
    rng = np.random.default_rng(17)
    stream = np.cumsum(rng.normal(size=(200, 3)).astype(np.float32), axis=0)
    stream = stream.astype(np.float32)
    stream[90:110] = sess.raw[4] + 0.001 * rng.normal(size=(20, 3)).astype(np.float32)
    m = sess.stream(threshold=2.0)
    m.push(stream)
    m.flush()
    assert (4, 90) in [(h.tid, h.start) for h in m.matches()]


def test_mv_engine_matches_direct_search_and_repro():
    """A QueryEngine over a 3-channel session: each (n, d) request's answer
    is a direct ``db.search``'s bits and the reference engine's answer;
    a univariate query raises the reference's ValueError."""
    x = mv_rows(14, rows=30)
    qs = mv_rows(15, rows=5)
    cfg = dict(w=W, p=1, znorm=True, block=8)
    db = Database.build(x, SearchConfig(**cfg), device="cpu")
    jdb = JDatabase.build(x, JConfig(**cfg))
    direct = db.search(qs, k=2)
    with QueryEngine(db, max_batch=4, max_wait_ms=1.0) as eng, \
            JQueryEngine(jdb, max_batch=4, max_wait_ms=1.0) as jeng:
        futs = [eng.submit(q, k=2) for q in qs]
        for i, f in enumerate(futs):
            ans = f.result(timeout=60)
            np.testing.assert_array_equal(ans.indices, direct.indices[i])
            np.testing.assert_array_equal(ans.distances, direct.distances[i])
            jans = jeng.search(qs[i], k=2)
            np.testing.assert_array_equal(ans.indices, jans.indices)
            np.testing.assert_allclose(ans.distances, jans.distances, rtol=2e-4)
        for engine in (eng, jeng):
            with pytest.raises(ValueError, match="channel"):
                engine.search(qs[0, :, 0], k=2)
        assert eng.search(qs[0], k=2).cache_hit
        assert eng.stats().served == len(qs) + 1


def test_mv_engine_open_stream_counts_values():
    """``open_stream`` on a d-channel session: the matches and stats of a
    direct ``db.stream``, and ``stream_samples`` counts m*d values (the
    reference's count of ``np.asarray(samples).size``)."""
    x = mv_rows(20, rows=6)
    db = Database.build(x, SearchConfig(w=W, p=2, block=8), device="cpu")
    rng = np.random.default_rng(21)
    stream = np.cumsum(rng.normal(size=(150, 3)), axis=0).astype(np.float32)
    stream[40 : 40 + N_LEN] = x[2]
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5) as engine:
        sess = engine.open_stream(threshold=1.5, hop=2)
        hits = []
        for lo in range(0, 150, 40):
            hits += sess.feed(stream[lo : lo + 40])
        sess.push(stream[:0])
        hits += sess.close()
        assert engine.stats().stream_samples == stream.size == 150 * 3
    ref = db.stream(threshold=1.5, hop=2)
    ref.push(stream)
    ref.flush()
    assert sorted(hits, key=lambda h: (h.start, h.tid)) == ref.matches()
    assert (2, 40) in [(h.tid, h.start) for h in hits]
    assert_same_stats(sess.stats, ref.stats)


# -------------------------------------------------------------- contracts


def test_mv_stream_error_contracts():
    """The reference's errors: a flat push that does not divide by d, a
    wrong column count, templates of another channel count, and a scanner
    handed the wrong number of channel states."""
    stream, templates = mv_stream(3)
    tm = tstream.StreamMatcher(templates, W, 1.0, d=3, device="cpu")
    jm = jstream.StreamMatcher(templates, W, 1.0, d=3)
    for m in (tm, jm):
        with pytest.raises(ValueError, match="does not divide by d=3"):
            m.push(np.zeros(7, np.float32))
        with pytest.raises(ValueError, match=r"expects \(m, 3\)"):
            m.push(np.zeros((5, 2), np.float32))
        with pytest.raises(ValueError, match="multivariate templates"):
            type(m)(templates[..., :2], W, 1.0, d=3,
                    **({"device": "cpu"} if m is tm else {}))
        with pytest.raises(ValueError, match="needs 3 channel states"):
            m.scanner.process_block(m.states[:2], 0, 1)
    with pytest.raises(ValueError, match="d must be >= 1"):
        tstream.StreamMatcher(templates, W, 1.0, d=0, device="cpu")


def test_mv_stream_defaults_to_the_gpu():
    """No GPU and no device: the d-channel entry points raise rather than
    run on the CPU quietly, as the univariate ones do."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None means the GPU")
    stream, templates = mv_stream(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamMatcher(templates, W, 1.0, d=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.windowed_matches(stream, templates, W, 1.0, d=2)
