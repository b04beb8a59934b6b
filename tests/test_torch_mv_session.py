"""repro_torch's multivariate sessions against ``repro.api.Database`` (CPU).

``Database.build`` on (N, n, d) random walks in both packages, searched
with (Q, n, d) queries through the scan, host and indexed drivers: the
same top-k indices and per-stage counters, distances within rtol 2e-4 at
float32 (1e-12 at float64, the JAX side in a subprocess with x64), raw
and z-normed.  Every method, the TC-DTW cascades and ``auto`` included,
gives ``full``'s answers; ``.npz`` bundles with ``channels`` pass both
ways; an (N, n, 1) build is the univariate session bit for bit (the
counterparts of ``tests/test_mv_parity.py``); and the contract errors of
``tests/test_mv.py::test_mv_contract_errors`` hold.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from helpers import run_in_subprocess  # noqa: E402
from repro.api import Database as JDatabase  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.mv import dtw_reference_mv, unflatten_channels  # noqa: E402

torch.set_num_threads(1)

D = 3
N_DB, N_LEN, W = 24, 20, 3
NQ = 3
METHODS = ("full", "lb_keogh", "lb_improved", "lb_webb", "kim_improved", "kim_webb",
           "tc_box", "tc_tri", "auto")


def mv_data(seed=0, n_db=N_DB, n=N_LEN, nq=NQ, d=D):
    rng = np.random.default_rng(seed)
    db = np.cumsum(rng.normal(size=(n_db, n, d)), axis=1).astype(np.float32)
    qs = np.cumsum(rng.normal(size=(nq, n, d)), axis=1).astype(np.float32)
    # a near-duplicate query: the regime where a wrong bound flips the top-k
    qs[1] = db[5] + 0.01 * rng.normal(size=(n, d)).astype(np.float32)
    return db, qs


def stats_key(s):
    return (s.n_candidates, s.full_dtw, s.stage_names, tuple(s.stage_pruned),
            s.lb0_pruned, s.ref_dtw, s.clusters_total, s.clusters_pruned,
            s.blocks_total, s.blocks_lb2, s.blocks_dtw, s.dp_lane_work, s.dp_lane_useful)


def same(jres, tres, rtol=2e-4, what=""):
    np.testing.assert_array_equal(tres.indices, np.asarray(jres.indices), err_msg=what)
    np.testing.assert_allclose(tres.distances, np.asarray(jres.distances), rtol=rtol,
                               err_msg=what)
    assert stats_key(tres.stats) == stats_key(jres.stats), what
    for a, b in zip(tres.per_query, jres.per_query):
        assert stats_key(a) == stats_key(b), what


def identical(a, b, what=""):
    np.testing.assert_array_equal(a.distances, b.distances, err_msg=what)
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=what)
    assert stats_key(a.stats) == stats_key(b.stats), what
    for sa, sb in zip(a.per_query, b.per_query):
        assert stats_key(sa) == stats_key(sb), what


@pytest.mark.parametrize("p,znorm", [(1, False), (1, True), (2, True), (np.inf, False)],
                         ids=["p1-raw", "p1-znorm", "p2-znorm", "pinf-raw"])
def test_mv_session_matches_repro(p, znorm):
    """Every driver against the reference, the float64 oracle, and the
    plan's channels line."""
    db, qs = mv_data(9)
    cfg = dict(w=W, p=p, znorm=znorm, block=8, k=3)
    jdb = JDatabase.build(db, JConfig(**cfg), index=True, n_refs=3, seed=0)
    tdb = Database.build(db, SearchConfig(**cfg), index=True, n_refs=3, seed=0, device="cpu")
    assert (tdb.channels, tdb.length, tdb.n_rows) == (D, N_LEN, N_DB)
    assert "x 3ch" in repr(tdb)
    np.testing.assert_array_equal(tdb.data, np.asarray(jdb.data))
    np.testing.assert_array_equal(tdb.upper, np.asarray(jdb.upper))
    np.testing.assert_array_equal(tdb.prepare_queries(qs), jdb.prepare_queries(qs))
    np.testing.assert_array_equal(tdb.index.ref_idx, jdb.index.ref_idx)
    prep = tdb.prepare_queries(qs)
    ref = np.array([[dtw_reference_mv(q, c, W, p) for c in unflatten_channels(tdb.data, D)]
                    for q in unflatten_channels(prep, D)])
    for driver in ("scan", "host", "indexed"):
        tres = tdb.search(qs, driver=driver)
        same(jdb.search(qs, driver=driver), tres, what=driver)
        np.testing.assert_array_equal(tres.indices,
                                      np.argsort(ref, axis=1, kind="stable")[:, :3])
        np.testing.assert_allclose(tres.distances, np.sort(ref, axis=1)[:, :3],
                                   rtol=2e-4, atol=1e-5)
        s = tres.stats
        assert s.lb0_pruned + sum(s.stage_pruned) + s.full_dtw == NQ * N_DB
    one = tdb.search(qs[0], driver="scan")
    np.testing.assert_array_equal(one.indices, tdb.search(qs, driver="scan").indices[0])
    plan, jplan = tdb.plan(prep), jdb.plan(prep)
    assert plan.channels == jplan.channels == D and plan.n_queries == NQ
    assert tdb.plan(qs[0]).n_queries == 1
    assert plan.explain().splitlines()[1:4] == jplan.explain().splitlines()[1:4]
    assert plan.reasons == jplan.reasons


def test_mv_methods_give_full_answers():
    """Every stage pipeline, the TC-DTW cascades and the planner's choice,
    on every driver: ``full``'s indices and distances."""
    db, qs = mv_data(10)
    tdb = Database.build(db, SearchConfig(w=W, p=1, znorm=True, block=8, k=2), index=True,
                         n_refs=3, seed=0, device="cpu")
    base = tdb.search(qs, method="full")
    for method in METHODS:
        for driver in ("scan", "host", "indexed"):
            res = tdb.search(qs, method=method, driver=driver)
            np.testing.assert_array_equal(res.indices, base.indices, err_msg=f"{method}/{driver}")
            np.testing.assert_allclose(res.distances, base.distances, rtol=1e-5,
                                       err_msg=f"{method}/{driver}")
    # tc_tri prunes with the reference context on the indexed route
    tri = tdb.search(qs, method="tc_tri", driver="indexed").stats.pruned_by
    assert set(tri) == {"tc_tri", "tc_box", "lb_keogh", "lb_improved"}


def test_mv_methods_and_tc_tri_match_repro():
    """The TC-DTW cascades and ``auto`` against the reference's counters
    (tc_tri with its reference context on the indexed route)."""
    db, qs = mv_data(10)
    cfg = dict(w=W, p=2, znorm=True, block=8, k=2)
    jdb = JDatabase.build(db, JConfig(**cfg), index=True, n_refs=3, seed=0)
    tdb = Database.build(db, SearchConfig(**cfg), index=True, n_refs=3, seed=0, device="cpu")
    for method, driver in (("tc_box", "scan"), ("tc_tri", "indexed"), ("auto", "scan"),
                           ("kim_improved", "host"), ("lb_webb", "host")):
        same(jdb.search(qs, method=method, driver=driver),
             tdb.search(qs, method=method, driver=driver), what=f"{method}/{driver}")


def test_mv_plan_explain_shows_channels():
    db, qs = mv_data(11)
    tdb = Database.build(db, SearchConfig(w=W, p=1, method="auto", block=8), device="cpu")
    jdb = JDatabase.build(db, JConfig(w=W, p=1, method="auto", block=8))
    plan = tdb.plan(tdb.prepare_queries(qs))
    assert plan.channels == D
    text = plan.explain()
    assert f"channels: {D}" in text and "tc_box" in text
    jtext = jdb.plan(jdb.prepare_queries(qs)).explain()
    assert text.splitlines()[1:4] == jtext.splitlines()[1:4]  # stages, queries, channels
    assert tdb.calibration.stage_names[-1] == "tc_box"


def test_mv_classify():
    db, qs = mv_data(12)
    labels = np.arange(N_DB) % 4
    tdb = Database.build(db, SearchConfig(w=W, p=2, block=8), device="cpu")
    ref = np.array([[dtw_reference_mv(q, c, W, 2) for c in db] for q in qs])
    np.testing.assert_array_equal(tdb.classify(labels, qs), labels[np.argmin(ref, axis=1)])
    assert tdb.classify(labels, qs[1]) == labels[5]


def test_mv_bundles_pass_both_ways(tmp_path):
    db, qs = mv_data(13)
    cfg = dict(w=W, p=1, znorm=True, block=8, k=2)
    jdb = JDatabase.build(db, JConfig(**cfg), index=True, n_refs=3, seed=0)
    want = jdb.search(qs, driver="indexed")
    tdb = Database.load(jdb.save(str(tmp_path / "ref")), device="cpu")
    assert tdb.channels == D and tdb.fingerprint == jdb.fingerprint
    assert tdb.index.d == D
    same(want, tdb.search(qs, driver="indexed"))
    with np.load(tmp_path / "ref.npz") as z:
        arrays = {k: z[k] for k in z.files}
    same(want, Database.from_arrays(arrays, device="cpu").search(qs, driver="indexed"))
    back = JDatabase.load(tdb.save(str(tmp_path / "port")))
    assert back.channels == D
    same(back.search(qs, driver="indexed"), tdb.search(qs, driver="indexed"))
    with np.load(tmp_path / "port.npz") as z:
        assert int(z["channels"]) == D and z["data"].shape == (N_DB, N_LEN, D)


@pytest.mark.parametrize("p,znorm", [(1, False), (2, True), (np.inf, True)],
                         ids=["p1-raw", "p2-znorm", "pinf-znorm"])
def test_unit_channel_axis_is_the_univariate_session(p, znorm):
    """Database.build(x[:, :, None]) == Database.build(x) bit for bit:
    artifacts, fingerprint and every driver's and method's answers."""
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.normal(size=(N_DB, 24)), axis=1).astype(np.float32)
    q = np.cumsum(rng.normal(size=(NQ, 24)), axis=1).astype(np.float32)
    q[1] = x[4] + 0.01
    cfg = SearchConfig(w=W, p=p, znorm=znorm, block=8, k=3)
    uni = Database.build(x, cfg, index=True, n_refs=3, seed=0, device="cpu")
    mv1 = Database.build(x[:, :, None], cfg, index=True, n_refs=3, seed=0, device="cpu")
    assert mv1.channels == 1 and mv1.fingerprint == uni.fingerprint
    assert mv1.data.tobytes() == uni.data.tobytes()
    for e1, e0 in zip(mv1.envelopes, uni.envelopes):
        assert e1.tobytes() == e0.tobytes()
    for driver in ("scan", "host", "indexed"):
        a = uni.search(q, driver=driver)
        identical(a, mv1.search(q[:, :, None], driver=driver), driver)
        identical(a, mv1.search(q, driver=driver), driver)
    for method in METHODS:
        identical(uni.search(q, method=method, driver="scan"),
                  mv1.search(q[:, :, None], method=method, driver="scan"), method)


def test_unit_channel_bundle_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    x = np.cumsum(rng.normal(size=(N_DB, 24)), axis=1).astype(np.float32)
    cfg = SearchConfig(w=W, p=1, znorm=True, block=8, k=2)
    uni = Database.build(x, cfg, device="cpu")
    path = Database.build(x[:, :, None], cfg, device="cpu").save(str(tmp_path / "d1"))
    mv1 = Database.load(path, device="cpu")
    assert mv1.channels == 1 and path.endswith(".npz")
    with np.load(path) as z:
        assert "channels" not in z.files
    identical(uni.search(x[:3]), mv1.search(x[:3]))


def test_mv_contract_errors():
    db, qs = mv_data(18)
    with pytest.raises(ValueError, match="channels=2"):
        Database.build(db, SearchConfig(w=W, channels=2), device="cpu")
    assert Database.build(db, SearchConfig(w=W, channels=3), device="cpu").channels == 3
    sess = Database.build(db, SearchConfig(w=W, block=8), device="cpu")
    with pytest.raises(ValueError):
        sess.prepare_queries(qs[:, :, :2])  # wrong channel count
    with pytest.raises(ValueError):
        sess.prepare_queries(qs[0, :, 0])  # univariate query on an mv session
    with pytest.raises(ValueError, match="length"):
        sess.prepare_queries(qs[:, :-1])
    with pytest.raises(ValueError, match="anytime"):
        Database.build(db, SearchConfig(w=W), anytime=True, device="cpu")
    # pre-flattened (Q, d*n) rows are accepted as they are
    prep = sess.prepare_queries(qs)
    np.testing.assert_array_equal(sess.prepare_queries(prep), prep)
    # mv sessions stream and serve: the rows are the stream's template
    # bank, and the engine takes one (n, d) query per request
    from repro_torch.serve import QueryEngine

    matcher = sess.stream(threshold=1.0)
    assert matcher.d == D and matcher.scanner._upper is sess._upper
    engine = QueryEngine(sess, start=False)
    with pytest.raises(ValueError, match="channel"):
        engine.submit(qs[0, :, 0])
    with pytest.raises(ValueError, match="channel"):
        engine.submit(qs)
    engine.close()


def test_mv_float64_host_matches_repro_x64():
    """precision='float64' on the host driver: the JAX side runs with x64 in
    a subprocess (never in this process); values agree to 1e-12."""
    db, qs = mv_data(19, n_db=30)
    db, qs = db.astype(np.float64), qs.astype(np.float64)
    code = f"""
import json, numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro.api import Database, SearchConfig
x = np.asarray({db.tolist()!r}); q = np.asarray({qs.tolist()!r})
cfg = SearchConfig(w={W}, k=3, p=2, block=8, precision="float64")
r = Database.build(x, cfg).search(q, driver="host")
print(json.dumps({{"i": np.asarray(r.indices).tolist(),
                  "d": np.asarray(r.distances).tolist(),
                  "s": [int(v) for v in r.stats.stage_pruned] + [int(r.stats.full_dtw)]}}))
"""
    out = json.loads(run_in_subprocess(code, n_devices=1).strip().splitlines()[-1])
    res = Database.build(db, SearchConfig(w=W, k=3, p=2, block=8, precision="float64"),
                         device="cpu").search(qs, driver="host")
    assert res.distances.dtype == np.float64
    np.testing.assert_array_equal(res.indices, np.asarray(out["i"]))
    np.testing.assert_allclose(res.distances, np.asarray(out["d"]), rtol=1e-12)
    assert [*res.stats.stage_pruned, res.stats.full_dtw] == out["s"]
