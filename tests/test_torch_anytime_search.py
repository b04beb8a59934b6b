"""repro_torch's anytime tier, search side, against repro.anytime (CPU).

The same seeded numpy inputs go through both packages at the shape of
``tests/test_anytime.py`` (24 x 80 at lengths (40, 80), hop 4, leaf 8,
w = 6).  The tier is built in ``repro`` and carried into the port with
``anytime_arrays`` / ``anytime_from_arrays``, so both search the same
tree bit for bit.  Over the reference's budget ladder, at p in {1, 2,
inf}, znorm off and on, subsequence and whole-row queries: equal
indices, row ids, starts and every ``AnytimeStats`` count; distances
within rtol 2e-4 (the DP's tolerance between the packages), error bounds
within 2e-4 of their distance and zero exactly where the reference's
are; ``residual_lb`` within rtol 2e-4 or infinite in both.  Within the
port: an unlimited budget bit-matches ``mode="exact"`` (the scan and
host drivers on the whole row, a plain brute force over the bank in
``(distance, gid)`` order for subsequence queries); error bounds are
sound at every budget on the shape of ``tests/test_anytime_soundness.py``
(20 x 72 at (36, 72), hop 3, leaf 6, w = 5), the tier built by the port;
a radii-free tree is still exact, and every stage pipeline answers as
``lb_improved``.  The planner's lines and errors are the reference's,
and a reference bundle with the tier answers in the port as in
``repro``.  The kernels' route is held against this one on the card in
``tests/test_torch_cuda.py``.
"""

import functools
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import anytime as J  # noqa: E402
from repro.api import Database as JDatabase  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro.core import lb as jlb  # noqa: E402
from repro_torch import anytime as T  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.core import lb as tlb  # noqa: E402
from repro_torch.core.dtw import finish_cost  # noqa: E402
from repro_torch.core.pipeline import PIPELINES  # noqa: E402
from repro_torch.data.synthetic import random_walks  # noqa: E402
from repro_torch.kernels.dtw.ops import dtw_qbatch_op  # noqa: E402

P_VALUES = [1, 2, math.inf]
#: the reference tests' sessions: rows, length, subsequence length, hop,
#: leaf size, band, k and the data's seed
SHAPES = {
    "anytime": dict(rows=24, n=80, m=40, hop=4, leaf=8, w=6, k=3, seed=3),
    "soundness": dict(rows=20, n=72, m=36, hop=3, leaf=6, w=5, k=3, seed=21),
}
#: AnytimeStats fields that must be equal between the packages
COUNTS = ("n_windows", "refined", "budget", "clusters_total", "clusters_explored",
          "nodes_expanded", "frontier", "ref_dtw", "full_dtw", "stage_names",
          "stage_pruned")
RTOL = 2e-4


@functools.lru_cache(maxsize=None)
def sessions(shape, p, znorm=False, radii=True):
    """(repro session, port session) on the same rows, the port's tier
    carried over from repro's arrays (the same tree, bit for bit)."""
    s = SHAPES[shape]
    data = random_walks(np.random.default_rng(s["seed"]), s["rows"], s["n"])
    cfg = dict(w=s["w"], p=p, k=s["k"], znorm=znorm)
    opts = dict(lengths=(s["m"], s["n"]), hop=s["hop"], leaf_size=s["leaf"], radii=radii)
    jdb = JDatabase.build(data, JConfig(**cfg), anytime=opts)
    tdb = Database.build(data, SearchConfig(**cfg), device="cpu")
    tdb.anytime = T.anytime_from_arrays(J.anytime_arrays(jdb.anytime), device="cpu",
                                        prepared=tdb.rows_tensor)
    return jdb, tdb


@functools.lru_cache(maxsize=None)
def port_session(shape, p):
    """The port's own session with the tier built by the port."""
    s = SHAPES[shape]
    data = random_walks(np.random.default_rng(s["seed"]), s["rows"], s["n"])
    return Database.build(data, SearchConfig(w=s["w"], p=p, k=s["k"]), device="cpu",
                          anytime=dict(lengths=(s["m"], s["n"]), hop=s["hop"],
                                       leaf_size=s["leaf"]))


def queries(n, length, seed=5):
    return random_walks(np.random.default_rng(seed), n, length)


def budget_ladder(db, m):
    """The reference's ladder (``tests/test_anytime_soundness.py``): the
    representative floor up to the whole bank."""
    li = db.anytime.tier(m)
    floor, n = li.tree.n_coarse, li.n_windows
    ladder = sorted({floor, floor + 3, max(floor, n // 8), n // 3, (2 * n) // 3, n})
    return [b for b in ladder if b >= 1]


def same_stats(got, want):
    for f in COUNTS:
        assert getattr(got, f) == getattr(want, f), f
    if math.isinf(want.residual_lb):
        assert math.isinf(got.residual_lb)
    else:
        assert got.residual_lb == pytest.approx(want.residual_lb, rel=RTOL)


def same_anytime(got, want):
    """An anytime result of the port against repro's."""
    assert type(got).__name__ == type(want).__name__
    for f in ("indices", "row_ids", "starts"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    assert got.distances.dtype == np.asarray(want.distances).dtype
    np.testing.assert_allclose(got.distances, want.distances, rtol=RTOL)
    err, want_err = got.error_bounds, np.asarray(want.error_bounds)
    np.testing.assert_array_equal(err == 0, want_err == 0)
    np.testing.assert_array_equal(np.isinf(err), np.isinf(want_err))
    # err = d - residual: both terms agree within RTOL of the distance, so
    # the bound does too (relative to the bound itself it cannot, where it
    # is small beside d)
    fin = np.isfinite(want_err)
    scale = np.asarray(want.distances, np.float64)[fin]
    assert np.all(np.abs(err[fin] - want_err[fin]) <= RTOL * scale)
    same_stats(got.stats, want.stats)
    for g, w in zip(getattr(got, "per_query", ()), getattr(want, "per_query", ())):
        same_stats(g.stats, w.stats)


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def brute_force(db, q, m, k):
    """Plain DP over the tier's whole bank -> (distances, gids) in the
    canonical (distance, gid) order."""
    li = db.anytime.tier(m)
    qs = torch.as_tensor(db.prepare_queries(q, length=m)[None])
    d = finish_cost(dtw_qbatch_op(qs, li.wins, li.w, db.p), db.p)[0].numpy()
    order = np.lexsort((np.arange(d.shape[0]), d))[:k]
    return d[order], order


# ------------------------------------------------------------- LB_Box


@pytest.mark.parametrize("p", P_VALUES)
def test_lb_box_matches_reference(p):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, 1, 50)).cumsum(axis=-1).astype(np.float32)
    u, l = q + 0.5, q - 0.5
    c = rng.normal(size=(4, 50)).cumsum(axis=-1).astype(np.float32)
    cmin, cmax = c - rng.random(c.shape, np.float32), c + rng.random(c.shape, np.float32)
    t = [torch.as_tensor(a) for a in (cmin, cmax, u, l)]
    # broadcast over leading dims: (3, 1, 50) envelopes against 4 boxes
    got = tlb.lb_box_powered(*t, p)
    want = np.asarray(jlb.lb_box_powered(cmin, cmax, u, l, p))
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(tlb.lb_box(*t, p).numpy(), np.asarray(jlb.lb_box(cmin, cmax, u, l, p)),
                               rtol=1e-6)
    # a box degenerated to one candidate is LB_Keogh exactly
    ct = torch.as_tensor(c)
    assert torch.equal(tlb.lb_box_powered(ct, ct, *t[2:], p),
                       tlb.lb_keogh_powered(ct, *t[2:], p))
    # the bound holds for every member of the box
    inside = torch.as_tensor(cmin + (cmax - cmin) * rng.random(c.shape, np.float32))
    assert bool((got <= tlb.lb_keogh_powered(inside, *t[2:], p)).all())


# ------------------------------------------------- against the reference


@pytest.mark.parametrize("znorm", [False, True])
@pytest.mark.parametrize("p", P_VALUES)
@pytest.mark.parametrize("whole", [False, True], ids=["m", "n"])
def test_anytime_matches_reference_over_the_ladder(whole, p, znorm):
    jdb, tdb = sessions("anytime", p, znorm)
    m = 80 if whole else 40
    qs = queries(2, m)
    for budget in budget_ladder(jdb, m) + [None]:
        same_anytime(tdb.search(qs, mode="anytime", budget=budget),
                     jdb.search(qs, mode="anytime", budget=budget))
    if not whole:  # the exact route for a subsequence-length query
        same_anytime(tdb.search(qs), jdb.search(qs))


def test_direct_calls_match_reference():
    """``anytime_search`` and ``exact_subsequence_search`` called directly
    (the whole-row tier too, which the session routes elsewhere), at
    another k, block and method."""
    jdb, tdb = sessions("anytime", 1)
    for m in (40, 80):
        qs = queries(2, m, seed=7)
        for method in ("lb_improved", "lb_keogh"):
            kw = dict(k=2, method=method)
            same_anytime(T.anytime_search(qs, tdb.anytime, budget=32, **kw),
                         J.anytime_search(qs, jdb.anytime, budget=32, **kw))
            same_anytime(T.exact_subsequence_search(qs, tdb.anytime, block=16, **kw),
                         J.exact_subsequence_search(qs, jdb.anytime, block=16, **kw))
    # the facade and the direct call are one route
    qs = np.asarray(queries(2, 40), np.float32)
    via_db = tdb.search(qs, k=2, mode="anytime", budget=32)
    direct = T.anytime_search(qs, tdb.anytime, k=2, method="lb_improved", budget=32)
    assert bits_equal(via_db.distances, direct.distances)
    assert bits_equal(tdb.search(qs, k=2).distances,
                      T.exact_subsequence_search(qs, tdb.anytime, k=2,
                                                 method="lb_improved", block=32).distances)


# --------------------------------------------------------- within the port


@pytest.mark.parametrize("znorm", [False, True])
@pytest.mark.parametrize("p", P_VALUES)
def test_unlimited_budget_bitmatches_exact(p, znorm):
    """Unlimited (and covering) budgets give ``mode="exact"``'s bits: the
    scan and host drivers on the whole row, a plain brute force over the
    bank for subsequence queries; every error bound 0."""
    _, db = sessions("anytime", p, znorm)
    qs = queries(4, 80, seed=17)
    got = db.search(qs, mode="anytime")
    for driver in ("scan", "host"):
        want = db.search(qs, driver=driver)
        assert bits_equal(got.distances, want.distances), driver
        assert bits_equal(got.indices, want.indices), driver
    assert bits_equal(got.indices, got.row_ids) and not got.starts.any()
    assert np.all(got.error_bounds == 0.0)
    qs = queries(4, 40, seed=13)
    exact = db.search(qs)
    n = db.anytime.tier(40).n_windows
    for res in (exact, db.search(qs, mode="anytime"), db.search(qs, mode="anytime", budget=n)):
        for qi, q in enumerate(qs):
            d, g = brute_force(db, q, 40, db.config.k)
            assert bits_equal(res.distances[qi], d) and bits_equal(res.indices[qi], g)
        assert np.all(res.error_bounds == 0.0)
        assert bits_equal(res.row_ids, db.anytime.tier(40).row_ids[exact.indices])
        assert bits_equal(res.starts, db.anytime.tier(40).starts[exact.indices])
    assert exact.stats.residual_lb == math.inf


@pytest.mark.parametrize("p", P_VALUES)
@pytest.mark.parametrize("whole", [False, True], ids=["m", "n"])
def test_error_bounds_sound_at_every_budget(whole, p):
    """The soundness property of ``tests/test_anytime_soundness.py`` in the
    port: ``0 <= d_j - t_j <= err_j`` against the exact answer."""
    db = port_session("soundness", p)
    m = 72 if whole else 36
    k = SHAPES["soundness"]["k"]
    qs = queries(4, m, seed=p if p != math.inf else 99)
    exact = db.search(qs, k=k, mode="anytime")
    for b in budget_ladder(db, m):
        res = db.search(qs, k=k, mode="anytime", budget=b)
        assert (res.indices >= 0).all(), b
        gap = res.distances.astype(np.float64) - exact.distances.astype(np.float64)
        assert np.all(gap >= -1e-9), b
        assert np.all(gap <= res.error_bounds + 1e-9), b
        assert np.all(res.error_bounds >= 0.0)
        assert res.stats.budget == b
    assert np.all(res.error_bounds == 0.0)  # the covering budget


def test_budget_caps_refinement_and_distances_only_improve():
    _, db = sessions("anytime", 2)
    floor = db.anytime.tier(40).tree.n_coarse
    q = queries(1, 40)[0]
    res = db.search(q, mode="anytime", budget=floor)
    assert res.stats.refined == floor and res.stats.budget == floor
    unlimited = db.search(q, mode="anytime")
    assert unlimited.stats.budget is None and unlimited.stats.refined >= floor
    assert np.all(unlimited.distances <= res.distances)
    assert 0.0 <= unlimited.stats.pruning_ratio <= 1.0
    assert set(unlimited.stats.pruned_by) == {"lb_keogh", "lb_improved"}


def test_radii_free_tree_is_still_exact():
    jdb, db = sessions("anytime", 2, radii=False)
    assert np.isinf(db.anytime.tier(40).tree.radii_w).all()
    for m in (40, 80):
        qs = queries(2, m)
        got = db.search(qs, mode="anytime")
        exact = db.search(qs, driver="scan") if m == 80 else db.search(qs)
        assert bits_equal(got.distances, exact.distances)
        assert bits_equal(got.indices, exact.indices)
        same_anytime(got, jdb.search(qs, mode="anytime"))


@pytest.mark.parametrize("method", ["lb_keogh", "kim_improved", "full"])
def test_every_pipeline_answers_as_lb_improved(method):
    """The stage pipeline changes what is pruned, never the answer: under
    a budget the refined windows are the tree's choice alone."""
    _, db = sessions("anytime", 1)
    for m in (40, 80):
        qs = queries(3, m, seed=23)
        for budget in (None, 40):
            got = db.search(qs, mode="anytime", budget=budget, method=method)
            want = db.search(qs, mode="anytime", budget=budget)
            assert bits_equal(got.distances, want.distances)
            assert bits_equal(got.indices, want.indices)
            assert got.stats.refined == want.stats.refined
            assert got.stats.stage_names == PIPELINES[method][:-1]


def test_result_types_and_batch_indexing():
    _, db = sessions("anytime", 2)
    qs = queries(3, 40)
    res = db.search(qs, k=2, mode="anytime", budget=32)
    assert isinstance(res, T.AnytimeBatchResult) and len(res) == 3
    assert res.distances.shape == (3, 2) and res.error_bounds.dtype == np.float64
    one = res[1]
    assert isinstance(one, T.AnytimeResult)
    assert bits_equal(one.distances, res.distances[1])
    assert one.distance == float(res.distances[1, 0]) and one.index == res.indices[1, 0]
    single = db.search(qs[0], k=2, mode="anytime", budget=32)
    assert isinstance(single, T.AnytimeResult)
    assert bits_equal(single.distances, res.distances[0])
    assert isinstance(db.search(qs[0]), T.AnytimeResult)  # the exact sub route


# ---------------------------------------------------------------- planner


def test_plan_explains_as_the_reference():
    from repro.api import DRIVERS as J_DRIVERS
    from repro_torch.api import DRIVERS

    assert {k: v.replace("repro_torch.", "repro.") for k, v in DRIVERS.items()} == J_DRIVERS
    jdb, db = sessions("anytime", 2)
    for q, kw in ((queries(2, 40), dict(mode="anytime", budget=64)),
                  (queries(2, 80), dict(mode="anytime")),
                  (queries(2, 40), {}),
                  (2, dict(length=40)),
                  (2, dict(mode="anytime", length=80))):
        got, want = db.plan(q, **kw), jdb.plan(q, **kw)
        assert (got.driver, got.stages, got.mode, got.budget) == (
            want.driver, want.stages, want.mode, want.budget)
        assert got.explain() == want.explain().replace("(repro.", "(repro_torch.")
    plan = db.plan(queries(2, 40), mode="anytime", budget=64)
    assert plan.stages[0] == "cluster_lb" and "budget 64" in plan.explain()
    assert "Theorem 1" in plan.explain()
    assert db.plan(queries(2, 80)).driver == jdb.plan(queries(2, 80)).driver == "scan"


def test_plan_and_budget_errors_match_reference():
    jdb, db = sessions("anytime", 2)
    data = random_walks(np.random.default_rng(0), 8, 32)
    jplain = JDatabase.build(data, JConfig(w=4))
    plain = Database.build(data, SearchConfig(w=4), device="cpu")
    q40, q80, q17 = queries(1, 40)[0], queries(1, 80)[0], queries(1, 17)[0]
    cases = [
        ("needs the anytime tier", lambda d: d.search(data[0], k=1, mode="anytime"), True),
        ("cannot be combined", lambda d: d.search(q40, k=1, mode="anytime", driver="scan"),
         False),
        ("not directly selectable", lambda d: d.plan(q80, driver="anytime"), False),
        ("not directly selectable", lambda d: d.plan(q80, driver="subsequence"), False),
        ("mode='bogus'", lambda d: d.search(q40, k=1, mode="bogus"), False),
        ("mode='bogus'", lambda d: d.plan(q40, mode="bogus"), False),
        ("built lengths", lambda d: d.search(q17, k=1), False),
        ("only applies to mode='anytime'", lambda d: d.search(q80, k=2, budget=8), False),
        ("only applies to mode='anytime'", lambda d: d.search(q40, k=2, budget=8), False),
        ("only applies to mode='anytime'", lambda d: d.plan(q40, budget=8), False),
        ("must be >= 1", lambda d: d.search(q40, k=2, mode="anytime", budget=0), False),
        ("anytime tier lengths", lambda d: d.prepare_queries(q17, length=40), False),
        ("k=", lambda d: d.search(q40, k=10**6, mode="anytime"), False),
    ]
    for text, call, on_plain in cases:
        got = raised(lambda: call(plain if on_plain else db))
        want = raised(lambda: call(jplain if on_plain else jdb))
        assert got == want, text
        assert got[0] is ValueError and text in got[1], text


# ----------------------------------------------------------------- bundles


def test_reference_bundle_answers_as_repro(tmp_path):
    jdb, _ = sessions("anytime", 2, True)
    back = Database.load(jdb.save(os.path.join(tmp_path, "ref")), device="cpu")
    assert back.anytime.tier(80).wins is back.rows_tensor
    for m in (40, 80):
        qs = queries(2, m, seed=31)
        for budget in (24, None):
            same_anytime(back.search(qs, mode="anytime", budget=budget),
                         jdb.search(qs, mode="anytime", budget=budget))
    same_anytime(back.search(queries(2, 40)), jdb.search(queries(2, 40)))
    # and the port's bundle answers the same after a round trip
    again = Database.load(back.save(os.path.join(tmp_path, "port")), device="cpu")
    qs = queries(2, 40, seed=32)
    a, b = again.search(qs, mode="anytime", budget=24), back.search(qs, mode="anytime", budget=24)
    assert bits_equal(a.distances, b.distances) and bits_equal(a.error_bounds, b.error_bounds)
