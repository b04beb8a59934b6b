"""repro_torch's streaming tier against repro.stream (CPU).

The same stream, templates and thresholds as ``tests/test_stream.py``
(N = 40, W = 4, 420 samples) go through both packages.  The port must
give the same match set ((tid, start) pairs), distances within rtol 2e-4
(its float32 DP is not the reference's to the bit), and every
``StreamStats`` field equal: the S0 prefilter is the reference's numpy
on the host, and the device stages prune the same lanes.  Without
z-normalization the scanner's first pass is K7's stream op over the
block's flat segment (its plain version here); the tests pin that route
and that K7's values change nothing in ``run_block_stages``.

The port's ``StreamState`` is the reference's numpy code and is held to
it bit for bit; its online envelope is held to the port's batch
envelope (K1's plain version) and ``envelope_naive``, subnormals
included (ROADMAP.md queue 3, C: the port keeps subnormals; JAX's CPU
envelope flushes them, so it is not the yardstick on such rows).
"""

import math
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.dtw import dtw_reference  # noqa: E402
from repro.core.envelope import envelope_naive  # noqa: E402
from repro.data.synthetic import planted_stream, template_bank  # noqa: E402
from repro import stream as jstream  # noqa: E402
from repro.api import Database as JDatabase  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro.launch import stream as j_cli  # noqa: E402
from repro_torch import stream as tstream  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.kernels.envelope.ops import envelope_op  # noqa: E402
from repro_torch.kernels.lb_keogh.ops import lb_keogh_stream_plain  # noqa: E402
from repro_torch.launch import stream as t_cli  # noqa: E402
from repro_torch.stream import subsequence as tsub  # noqa: E402

torch.set_num_threads(1)

N = 40
W = 4
RNG = np.random.default_rng(123)
TEMPLATES = template_bank(N, kinds=("sine", "gaussian"))
STREAM, PLANTS = planted_stream(RNG, 420, TEMPLATES, 3, noise_level=0.08)

THRESHOLDS = {  # tests/test_stream.py's: between plant and noise distances
    (1, False): 8.0,
    (1, True): 22.0,
    (2, False): 1.8,
    (2, True): 3.6,
    (math.inf, False): 0.6,
    (math.inf, True): 1.2,
}

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


def chunked(matcher, stream, chunk):
    """Push ``stream`` in ``chunk``-sample pieces, polling after each, then
    flush; the polled matches in stream order."""
    got = []
    for lo in range(0, len(stream), chunk):
        matcher.push(stream[lo : lo + chunk])
        got.extend(matcher.poll())
    matcher.flush()
    got.extend(matcher.poll())
    return sorted(got, key=lambda h: (h.start, h.tid))


def oracle_matches(stream, templates, w, threshold, p, hop, znorm, exclusion):
    """``tests/test_stream.py``'s naive scan: one reference DP per
    (template, window), threshold, offline greedy exclusion."""
    templates = np.atleast_2d(templates)
    n = templates.shape[1]
    starts = np.arange(0, len(stream) - n + 1, hop)
    c1, c2 = jstream.prefix_sums(stream)
    mean, std = jstream.window_mean_std_from_prefix(c1, c2, starts, n)
    thr = np.broadcast_to(np.asarray(threshold, np.float64), (len(templates),))
    hits = []
    for tid, q in enumerate(templates):
        qz = jstream.znorm_series(q) if znorm else q
        for j, s in enumerate(starts):
            win = stream[s : s + n]
            if znorm:
                win = jstream.znorm_windows(win[None, :], mean[j : j + 1],
                                            std[j : j + 1])[0]
            d = dtw_reference(qz, win, w, p)
            if d <= thr[tid]:
                hits.append(jstream.Match(tid, int(s), float(d)))
    return jstream.greedy_suppress(hits, exclusion)


# ------------------------------------------------------------ StreamState


@pytest.mark.parametrize("w", [0, 1, 3, 9])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_stream_state_bitmatches_repro(w, chunk):
    """Envelopes, views, the right-truncated tail and the rolling stats of
    the port's ring are the reference's bits, for every chunking and a
    ring that evicts."""
    xs = STREAM.astype(np.float32)
    cap = 3 * 64
    ts, js = tstream.StreamState(cap, w), jstream.StreamState(cap, w)
    for lo in range(0, len(xs), chunk):
        ts.push(xs[lo : lo + chunk])
        js.push(xs[lo : lo + chunk])
        start = ts.oldest
        length = ts.count - start
        np.testing.assert_array_equal(ts.view(start, length), js.view(start, length))
        for a, b in zip(ts.envelope_view(start, length), js.envelope_view(start, length)):
            np.testing.assert_array_equal(a, b)
    n = 20
    starts = np.arange(ts.oldest + 1, ts.count - n + 1, 3)
    for a, b in zip(ts.window_mean_std(starts, n), js.window_mean_std(starts, n)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ts.view(0, 5)  # evicted


def test_online_envelope_keeps_subnormals():
    """Fault C's case: [0, 1.0118855e-38] at w = 1.  The online envelope
    equals the batch envelope (K1's plain version) and the numpy oracle,
    subnormal and all."""
    xs = np.array([0.0, 1.0118855e-38], np.float32)
    assert 0 < xs[1] < np.finfo(np.float32).tiny  # a float32 subnormal
    st = tstream.StreamState(capacity=8, w=1)
    st.push(xs)
    u, l = st.envelope_view(0, 2)
    ub, lb = envelope_op(torch.from_numpy(xs)[None], 1)
    un, ln = envelope_naive(xs, 1)
    for got in (ub[0].numpy(), un):
        np.testing.assert_array_equal(u, got)
    for got in (lb[0].numpy(), ln):
        np.testing.assert_array_equal(l, got)
    assert u[0] == xs[1] and u[1] == xs[1]  # kept, not flushed to 0


# ------------------------------------------------- scanner and matcher


@pytest.mark.parametrize("p", [1, 2, math.inf])
@pytest.mark.parametrize("znorm", [False, True])
def test_matcher_matches_repro_and_oracle(p, znorm):
    """The streamed (37-sample chunks) and offline scans at hop 2, block
    32: the reference's match set, distances within rtol 2e-4, every
    stats field; the port's two scans agree bit for bit; the naive
    oracle agrees."""
    thr = THRESHOLDS[(p, znorm)]
    kw = dict(p=p, hop=2, znorm=znorm, block=32)
    want, want_stats = jstream.windowed_matches(STREAM, TEMPLATES, W, thr, **kw)
    assert want, "the reference found no matches"
    offline, stats = tstream.windowed_matches(STREAM, TEMPLATES, W, thr, device="cpu", **kw)
    assert_same_matches(offline, want)
    assert_same_stats(stats, want_stats)
    np.testing.assert_array_equal(
        stats.env_pruned + stats.stage_pruned.sum(axis=0) + stats.full_dtw, stats.n_windows)

    m = tstream.StreamMatcher(TEMPLATES, W, thr, device="cpu", **kw)
    jm = jstream.StreamMatcher(TEMPLATES, W, thr, **kw)
    got = chunked(m, STREAM, 37)
    assert_same_matches(got, chunked(jm, STREAM, 37))
    assert_same_stats(m.stats, jm.stats)
    assert [h.dist for h in got] == [h.dist for h in offline]  # bit-identical
    assert_same_matches(got, oracle_matches(STREAM, TEMPLATES, W, thr, p, 2, znorm, N))


@pytest.mark.parametrize("hop", [1, 3])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_hops_and_chunkings_match_repro(hop, chunk):
    """hop in {1, 3} and pushes of 1, 7 and 64 samples (p = 2): matches and
    stats equal to the reference's matcher under the same chunking."""
    thr = THRESHOLDS[(2, False)]
    kw = dict(p=2, hop=hop, block=16)
    m = tstream.StreamMatcher(TEMPLATES, W, thr, device="cpu", **kw)
    jm = jstream.StreamMatcher(TEMPLATES, W, thr, **kw)
    got = chunked(m, STREAM[:300], chunk)
    assert_same_matches(got, chunked(jm, STREAM[:300], chunk))
    assert_same_stats(m.stats, jm.stats)
    assert m.windows_evaluated == (300 - N) // hop + 1
    assert all(h.start % hop == 0 for h in got)


def test_hit_straddling_two_blocks():
    """A hit whose window spans several sweep blocks (n >> block * hop),
    as in ``tests/test_stream.py``: the oracle's and the reference's."""
    stream = (0.05 * np.random.default_rng(7).standard_normal(200)).astype(np.float32)
    pos = 10
    stream[pos : pos + N] += TEMPLATES[0]
    want = oracle_matches(stream, TEMPLATES[:1], W, 1.5, 2, 1, False, N)
    assert any(h.start == pos for h in want)
    kw = dict(p=2, hop=1, block=16)
    m = tstream.StreamMatcher(TEMPLATES[:1], W, 1.5, device="cpu", **kw)
    jm = jstream.StreamMatcher(TEMPLATES[:1], W, 1.5, **kw)
    got = chunked(m, stream, 13)
    assert_same_matches(got, want)
    assert_same_matches(got, chunked(jm, stream, 13))
    assert_same_stats(m.stats, jm.stats)


@pytest.mark.parametrize("znorm", [False, True])
def test_small_ring_matches_unbounded(znorm):
    """The default ring (twice the block span, smaller than the stream)
    with one oversized push equals the offline scan, as in the reference."""
    thr = THRESHOLDS[(2, znorm)]
    kw = dict(p=2, hop=1, block=16, znorm=znorm)
    offline, _ = tstream.windowed_matches(STREAM, TEMPLATES, W, thr, device="cpu", **kw)
    m = tstream.StreamMatcher(TEMPLATES, W, thr, device="cpu", **kw)
    jm = jstream.StreamMatcher(TEMPLATES, W, thr, **kw)
    assert m.state.capacity < len(STREAM)
    m.push(STREAM)
    m.flush()
    jm.push(STREAM)
    jm.flush()
    assert m.matches() == offline
    assert_same_matches(m.matches(), jm.matches())
    assert_same_stats(m.stats, jm.stats)
    with pytest.raises(RuntimeError):
        m.push(STREAM[:10])  # closed


@pytest.mark.parametrize("method", ["lb_keogh", "full", "kim_improved", "lb_webb"])
def test_other_methods_match_repro(method):
    """The stream under each stage pipeline: K7 where LB_Keogh is the
    first stage, the pipeline's own first stage elsewhere."""
    thr = THRESHOLDS[(1, False)]
    kw = dict(p=1, hop=2, block=32, method=method)
    got, stats = tstream.windowed_matches(STREAM, TEMPLATES, W, thr, device="cpu", **kw)
    want, want_stats = jstream.windowed_matches(STREAM, TEMPLATES, W, thr, **kw)
    assert_same_matches(got, want)
    assert_same_stats(stats, want_stats)


# ------------------------------------------------ K7 as the first pass


@pytest.mark.parametrize("method", ["lb_keogh", "lb_improved"])
@pytest.mark.parametrize("p", [1, 2, math.inf])
def test_first_pass_values_change_nothing(method, p):
    """``run_block_stages`` with K7's plain values of the block's flat
    segment passed in as the first stage's equals the run that computes
    LB_Keogh on the tile itself: the same distances, masks and counters."""
    rng = np.random.default_rng(5)
    n, hop, block = N, 3, 24
    seg = torch.from_numpy(rng.standard_normal((block - 1) * hop + n).astype(np.float32))
    qs = torch.from_numpy(TEMPLATES)
    upper, lower = envelope_op(qs, W)
    blk = seg.unfold(0, n, hop).contiguous()
    mask0 = torch.from_numpy(rng.random((qs.shape[0], block)) < 0.8)
    bound = torch.tensor([40.0, 25.0]) if p != math.inf else torch.tensor([2.0, 1.5])
    want = pipeline.run_block_stages(qs, upper, lower, W, p, method, blk, bound, mask0)
    first = lb_keogh_stream_plain(seg, upper, lower, n, hop, p)[0]
    got = pipeline.run_block_stages(qs, upper, lower, W, p, method, blk, bound, mask0,
                                    first=first)
    assert torch.equal(got.d, want.d)
    assert len(got.masks) == len(want.masks)
    assert all(torch.equal(a, b) for a, b in zip(got.masks, want.masks))
    assert got[2:] == want[2:]
    assert any(bool(m.any()) for m in want.masks[1:]) or p == math.inf


@pytest.mark.parametrize("znorm", [False, True])
def test_first_pass_route(monkeypatch, znorm):
    """Without z-normalization S1 is one K7 call a block and the tile's
    dense LB_Keogh never runs; with it, the dense stage runs and K7 does
    not."""
    calls = {"k7": 0, "dense": 0}
    k7, dense = tsub.lb_keogh_stream_qbatch_op, pipeline.STAGES["lb_keogh"].dense

    def count_k7(*a, **k):
        calls["k7"] += 1
        return k7(*a, **k)

    def count_dense(*a, **k):
        calls["dense"] += 1
        return dense(*a, **k)

    monkeypatch.setattr(tsub, "lb_keogh_stream_qbatch_op", count_k7)
    monkeypatch.setitem(pipeline.STAGES, "lb_keogh",
                        pipeline.Stage("lb_keogh", count_dense,
                                       pipeline.STAGES["lb_keogh"].pair))
    thr = THRESHOLDS[(2, znorm)]
    _, stats = tstream.windowed_matches(STREAM, TEMPLATES, W, thr, p=2, hop=2,
                                        znorm=znorm, block=32, device="cpu")
    blocks = stats.blocks_total
    assert blocks == 6
    assert (calls["k7"], calls["dense"]) == ((0, blocks) if znorm else (blocks, 0))


# ------------------------------------------------------- session and CLI


def test_database_stream_matches_repro():
    """``db.stream`` in both packages: the rows as templates with the
    build envelopes reused (float32, no z-norm), explicit templates with
    their own, the same matches and stats; (Q, n, 2) templates on this
    univariate session, and 2-D templates for a 2-channel matcher, raise
    the reference's ValueError, and a 2-channel matcher gives the
    reference's matches and stats."""
    cfg = dict(w=W, p=2, block=32)
    tdb = Database.build(TEMPLATES, SearchConfig(**cfg), device="cpu")
    jdb = JDatabase.build(TEMPLATES, JConfig(**cfg))
    thr = THRESHOLDS[(2, False)]
    tm, jm = tdb.stream(threshold=thr, hop=2), jdb.stream(threshold=thr, hop=2)
    assert tm.scanner._upper is tdb._upper and tm.scanner._lower is tdb._lower
    assert tm.device == tdb.device
    tm.push(STREAM)
    tm.flush()
    jm.push(STREAM)
    jm.flush()
    assert_same_matches(tm.matches(), jm.matches())
    assert_same_stats(tm.stats, jm.stats)
    explicit = tdb.stream(TEMPLATES[:1], threshold=thr, hop=2)
    assert explicit.scanner._upper is not tdb._upper
    mv_tpl = np.stack([TEMPLATES, 0.5 * TEMPLATES], axis=-1)
    for db in (tdb, jdb):
        with pytest.raises(ValueError):
            db.stream(mv_tpl, threshold=thr)
    with pytest.raises(ValueError, match="multivariate templates"):
        tstream.StreamMatcher(TEMPLATES, W, thr, d=2, device="cpu")
    with pytest.raises(ValueError, match="multivariate templates"):
        jstream.StreamMatcher(TEMPLATES, W, thr, d=2)
    two = np.stack([STREAM, 0.5 * STREAM], axis=-1)
    tm2 = tstream.StreamMatcher(mv_tpl, W, 1.25 * thr, p=2, hop=2, block=32, d=2,
                                device="cpu")
    jm2 = jstream.StreamMatcher(mv_tpl, W, 1.25 * thr, p=2, hop=2, block=32, d=2)
    for m in (tm2, jm2):
        m.push(two)
        m.flush()
    assert len(jm2.matches()) > 0
    assert_same_matches(tm2.matches(), jm2.matches())
    assert_same_stats(tm2.stats, jm2.stats)


def test_database_stream_znorm_reuse_rule():
    """Under z-norm the build envelopes are reused only at the default std
    floor (the reference's rule), and both give the reference's matches."""
    cfg = dict(w=W, p=2, block=32, znorm=True)
    tdb = Database.build(TEMPLATES, SearchConfig(**cfg), device="cpu")
    jdb = JDatabase.build(TEMPLATES, JConfig(**cfg))
    thr = THRESHOLDS[(2, True)]
    reuse = tdb.stream(threshold=thr, hop=2)
    own = tdb.stream(threshold=thr, hop=2, eps=1e-6)
    assert reuse.scanner._upper is tdb._upper
    assert own.scanner._upper is not tdb._upper
    for m in (reuse, own):
        m.push(STREAM)
        m.flush()
    jm = jdb.stream(threshold=thr, hop=2)
    jm.push(STREAM)
    jm.flush()
    assert_same_matches(reuse.matches(), jm.matches())
    assert_same_stats(reuse.stats, jm.stats)
    assert_same_matches(own.matches(), jm.matches())


def test_no_device_raises():
    """No GPU and no device: the stream entry points raise rather than run
    on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None means the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamMatcher(TEMPLATES, W, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.windowed_matches(STREAM, TEMPLATES, W, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["--samples", "600", "--length", "32"])


def _result_lines(out: str):
    return [ln for ln in out.splitlines() if ln.startswith(("matches=", "pruned before",
                                                            "stream=", "  t="))]


@pytest.mark.parametrize("args", [
    ["--samples", "3000", "--length", "48"],
    ["--samples", "2400", "--length", "32", "--p", "inf", "--znorm", "--hop", "2"],
])
def test_stream_cli_matches_repro(capsys, monkeypatch, args):
    """``repro_torch.launch.stream --device cpu`` prints the reference's
    thresholds, match lines, pruning line and ``matches=`` line."""
    t_cli.main(["--device", "cpu", *args])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["repro.launch.stream", *args])
    j_cli.main()
    ref = capsys.readouterr().out
    assert _result_lines(port) == _result_lines(ref)
    assert any(ln.startswith("matches=") for ln in _result_lines(port))


def test_motion_segmentation_example_runs_small():
    """``examples/motion_segmentation_torch.py`` at 3,000 samples on the
    CPU: every planted occurrence, nothing else, the offline scan's set."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
        "motion_segmentation_torch.py"
    spec = importlib.util.spec_from_file_location("motion_segmentation_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    segments, stats = mod.main(3000, "cpu")
    assert stats.blocks_total > 0
    # the example's own stream: the same seed, templates and calibration
    from repro_torch.data.synthetic import planted_stream as t_planted
    from repro_torch.data.synthetic import template_bank as t_bank
    from repro_torch.launch.stream import calibrate_thresholds

    templates = t_bank(mod.N, kinds=("sine", "gaussian"))
    stream, plants = t_planted(np.random.default_rng(42), 3000, templates, 2,
                               noise_level=0.05)
    found = sorted(segments, key=lambda m: m.start)
    assert len(plants) == 2 and len(found) == len(plants)
    for (tid, pos, _), m in zip(plants, found):
        assert m.tid == tid and abs(m.start - pos) <= mod.HOP
    thr = calibrate_thresholds(templates, stream[:2048], mod.W, 2, mod.HOP, False,
                               frac=0.2, device="cpu")
    offline, _ = tstream.windowed_matches(stream, templates, mod.W, thr, p=2, hop=mod.HOP,
                                          device="cpu")
    assert sorted(segments, key=lambda m: (m.start, m.tid)) == offline


def test_launch_counts_survive_threads():
    """The launch counters take a lock: 16 threads adding 2,000 each (with
    a short switch interval) lose no count."""

    def fake():
        pass

    fake.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kcommon.count_launch(fake)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == 16 * 2000
