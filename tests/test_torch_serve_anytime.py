"""repro_torch's ``QueryEngine`` in ``mode="anytime"`` against repro's (CPU).

The sessions are those of ``tests/test_anytime.py`` (24 x 80 at lengths
(40, 80), hop 4, leaf 8, w = 6, k = 3): the tier is built in ``repro``
and carried into the port with ``anytime_arrays`` /
``anytime_from_arrays``, so both engines explore the same tree.  Over no
budget and the reference's budget ladder, at p in {1, 2}, znorm off and
on, at the whole length and at the subsequence length, each engine's
answer against the other's: equal indices, row ids and starts (read from
the tier at the answer's indices) and every ``AnytimeStats`` count;
distances within rtol 2e-4 (the DP's tolerance between the packages);
error bounds zero exactly where the reference's are and within 2e-4 of
the distance elsewhere (the tolerances of
``tests/test_torch_anytime_search.py``).  A cache hit replays the cold
answer's bounds; a deadline maps onto ``max(1, int(rate * deadline))``
refined windows once ``_refine_rate`` is set (to the same value in both
engines); the refine-rate EMA follows ``0.7 * old + 0.3 * new`` under a
stubbed engine clock; ``EngineStats``' anytime fields equal repro's; and
every validation error has the reference's type and text.  Within the
port, each answer is bit-equal to a direct ``db.search(mode="anytime",
budget=)``, a one-rank mesh is served, and a multi-rank mesh attached
after the engine was made fails the anytime batch.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from repro import anytime as J  # noqa: E402
from repro.api import Database as JDatabase  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro.serve import QueryEngine as JQueryEngine  # noqa: E402
from repro.serve import engine as j_engine_mod  # noqa: E402
from repro_torch import anytime as T  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.data.synthetic import random_walks  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.serve import QueryEngine  # noqa: E402
from repro_torch.serve import engine as t_engine_mod  # noqa: E402

torch.set_num_threads(1)

N_DB, N, M, HOP, LEAF, W, K = 24, 80, 40, 4, 8, 6, 3
OPTS = dict(lengths=(M, N), hop=HOP, leaf_size=LEAF)
#: AnytimeStats fields that must be equal between the packages
COUNTS = ("n_windows", "refined", "budget", "clusters_total", "clusters_explored",
          "nodes_expanded", "frontier", "ref_dtw", "full_dtw", "stage_names",
          "stage_pruned")
RTOL = 2e-4
ENGINE = dict(max_batch=4, max_wait_ms=1.0)


@functools.lru_cache(maxsize=None)
def sessions(p, znorm=False):
    """(repro session, port session) on the same rows, the port's tier
    carried over from repro's arrays (the same tree, bit for bit)."""
    data = random_walks(np.random.default_rng(3), N_DB, N)
    cfg = dict(w=W, p=p, k=K, znorm=znorm)
    jdb = JDatabase.build(data, JConfig(**cfg), anytime=OPTS)
    tdb = Database.build(data, SearchConfig(**cfg), device="cpu")
    tdb.anytime = T.anytime_from_arrays(J.anytime_arrays(jdb.anytime), device="cpu",
                                        prepared=tdb.rows_tensor)
    return jdb, tdb


def queries(n, length, seed=5):
    return random_walks(np.random.default_rng(seed), n, length)


def budget_ladder(db, m):
    """No budget, then the reference's ladder
    (``tests/test_anytime_soundness.py``): the representative floor up to
    the whole bank."""
    li = db.anytime.tier(m)
    floor, n = li.tree.n_coarse, li.n_windows
    ladder = sorted({floor, floor + 3, max(floor, n // 8), n // 3, (2 * n) // 3, n})
    return [None] + [b for b in ladder if b >= 1]


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def same_answer(got, want, tdb, jdb, m):
    """One port engine answer against repro's engine's answer."""
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    t_li, j_li = tdb.anytime.tier(m), jdb.anytime.tier(m)
    for f in ("row_ids", "starts"):
        np.testing.assert_array_equal(getattr(t_li, f)[got.indices],
                                      np.asarray(getattr(j_li, f))[np.asarray(want.indices)])
    assert got.distances.dtype == np.asarray(want.distances).dtype
    np.testing.assert_allclose(got.distances, want.distances, rtol=RTOL)
    err, want_err = got.error_bounds, np.asarray(want.error_bounds)
    np.testing.assert_array_equal(err == 0, want_err == 0)
    np.testing.assert_array_equal(np.isinf(err), np.isinf(want_err))
    fin = np.isfinite(want_err)
    scale = np.asarray(want.distances, np.float64)[fin]
    assert np.all(np.abs(err[fin] - want_err[fin]) <= RTOL * scale)
    for f in COUNTS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert (got.cache_hit, got.coalesced) == (want.cache_hit, want.coalesced)


def same_anytime_fields(got, want, scale):
    assert got.anytime_served == want.anytime_served
    assert got.clusters_explored == want.clusters_explored
    assert abs(got.residual_bound_mean - want.residual_bound_mean) <= RTOL * scale


def raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
@pytest.mark.parametrize("p", [1, 2])
def test_engine_anytime_matches_reference_on_the_ladder(p, znorm):
    """Both engines serve the same requests one at a time: no budget and
    the ladder, at the subsequence and the whole length; then a cache hit
    of each, which replays the cold answer's bounds."""
    jdb, tdb = sessions(p, znorm)
    requests = [(q, m, b) for m in (M, N) for b in budget_ladder(jdb, m)
                for q in queries(1, m)]
    scale = 0.0
    with QueryEngine(tdb, **ENGINE) as t_eng, JQueryEngine(jdb, **ENGINE) as j_eng:
        for q, m, b in requests:
            got = t_eng.search(q, mode="anytime", budget=b)
            want = j_eng.search(q, mode="anytime", budget=b)
            same_answer(got, want, tdb, jdb, m)
            assert not got.cache_hit and got.batch_lanes == 1
            scale = max(scale, float(np.max(want.distances)))
            direct = tdb.search(q, mode="anytime", budget=b)
            for f in ("distances", "indices", "error_bounds"):
                assert bits_equal(getattr(got, f), getattr(direct, f)), f
        q, m, b = requests[-1]
        hit = t_eng.search(q, mode="anytime", budget=b)
        j_hit = j_eng.search(q, mode="anytime", budget=b)
        assert hit.cache_hit and j_hit.cache_hit
        assert bits_equal(hit.error_bounds, got.error_bounds)
        same_answer(hit, j_hit, tdb, jdb, m)
        t_stats, j_stats = t_eng.stats(), j_eng.stats()
    assert t_stats.anytime_served == len(requests) + 1
    assert t_stats.cache_hits == j_stats.cache_hits == 1
    same_anytime_fields(t_stats, j_stats, scale)


def test_deadline_maps_onto_a_budget():
    """With ``_refine_rate`` set to the same value in both engines, a
    deadline request is served at ``max(1, int(rate * deadline))`` refined
    windows; an explicit budget wins over the deadline."""
    jdb, tdb = sessions(2)
    q = queries(1, M, seed=9)[0]
    with QueryEngine(tdb, **ENGINE) as t_eng, JQueryEngine(jdb, **ENGINE) as j_eng:
        for rate, deadline in ((2.5, 30.0), (1e-3, 30.0)):
            t_eng._refine_rate = j_eng._refine_rate = rate
            got = t_eng.search(q, mode="anytime", deadline=deadline)
            want = j_eng.search(q, mode="anytime", deadline=deadline)
            assert got.stats.budget == max(1, int(rate * deadline)) == want.stats.budget
            same_answer(got, want, tdb, jdb, M)
        explicit = t_eng.search(q, mode="anytime", deadline=30.0, budget=40)
        assert explicit.stats.budget == 40


class SteppingClock:
    """A stand-in for the engine module's ``time``: ``monotonic`` advances
    by ``step`` seconds a call, so a batch's ``dt`` is one step."""

    def __init__(self, step):
        self.t, self.step = 1000.0, step

    def monotonic(self):
        self.t += self.step
        return self.t


def run_batches(engine, batches):
    """Submit each batch of (query, budget) to an unstarted engine, and
    execute it in this thread."""
    for batch in batches:
        futures = [engine.submit(q, mode="anytime", budget=b) for q, b in batch]
        with engine._cv:
            formed = engine._form_batch_locked()
        engine._execute(*formed)
        yield [f.result(timeout=0) for f in futures]


def test_refine_rate_ema_under_a_stubbed_clock(monkeypatch):
    """The first batch's ``refined / dt / lanes`` seeds the EMA, each later
    one updates it by ``0.7 * old + 0.3 * new``; the port's rate equals
    repro's under the same stub."""
    jdb, tdb = sessions(1)
    step = 0.25
    monkeypatch.setattr(t_engine_mod, "time", SteppingClock(step))
    monkeypatch.setattr(j_engine_mod, "time", SteppingClock(step))
    qs = queries(3, M, seed=13)
    batches = [[(qs[0], 30), (qs[1], 30)], [(qs[2], 60)], [(qs[0], None)]]
    t_eng = QueryEngine(tdb, start=False, **ENGINE)
    j_eng = JQueryEngine(jdb, start=False, **ENGINE)
    want_rate, scale = None, 0.0
    for got, want in zip(run_batches(t_eng, batches), run_batches(j_eng, batches)):
        for a, b in zip(got, want):
            same_answer(a, b, tdb, jdb, M)
            scale = max(scale, float(np.max(b.distances)))
        rate = sum(a.stats.refined for a in got) / step / len(got)
        want_rate = rate if want_rate is None else 0.7 * want_rate + 0.3 * rate
        assert t_eng._refine_rate == want_rate == j_eng._refine_rate
    t_stats, j_stats = t_eng.stats(), j_eng.stats()
    assert (t_stats.batches, t_stats.batch_lanes, t_stats.anytime_served) == (3, 4, 4)
    same_anytime_fields(t_stats, j_stats, scale)


def test_engine_stats_are_the_sums_over_the_answers():
    """``anytime_served``, ``clusters_explored`` and ``residual_bound_mean``
    over mixed exact and anytime requests, cache hits included (a hit adds
    its bound and its request, not its clusters), as repro counts them."""
    jdb, tdb = sessions(2, znorm=True)
    qs, rows = queries(2, M, seed=17), queries(2, N, seed=19)
    plan = [(qs[0], "anytime", 24), (rows[0], "exact", None), (qs[1], "anytime", None),
            (qs[0], "anytime", 24), (rows[1], "anytime", 12), (rows[0], "exact", None)]
    with QueryEngine(tdb, **ENGINE) as t_eng, JQueryEngine(jdb, **ENGINE) as j_eng:
        answers = []
        for q, mode, b in plan:
            got = t_eng.search(q, mode=mode, budget=b)
            want = j_eng.search(q, mode=mode, budget=b)
            np.testing.assert_array_equal(got.indices, want.indices)
            assert got.cache_hit == want.cache_hit
            np.testing.assert_allclose(got.distances, want.distances, rtol=RTOL)
            answers.append((mode, got))
        t_stats, j_stats = t_eng.stats(), j_eng.stats()
    any_answers = [a for mode, a in answers if mode == "anytime"]
    cold = [a for a in any_answers if not a.cache_hit]
    assert t_stats.anytime_served == len(any_answers) == 4
    assert t_stats.clusters_explored == sum(a.stats.clusters_explored for a in cold)
    assert t_stats.residual_bound_mean == pytest.approx(
        sum(a.error_bound for a in any_answers) / len(any_answers), rel=1e-12)
    assert t_stats.cache_hits == 2 and [a.error_bounds is None for _, a in answers] == [
        False, True, False, False, False, True]
    scale = max(float(np.max(a.distances)) for a in any_answers)
    same_anytime_fields(t_stats, j_stats, scale)


def test_validation_errors_are_the_references():
    """Each refusal of ``submit`` has repro's type and text, in repro's
    order: no tier, ``driver=`` with anytime, an unbuilt length, a budget
    below 1, ``k`` beyond the tier's windows, a budget without anytime
    and an unknown mode."""
    jdb, tdb = sessions(1)
    data = random_walks(np.random.default_rng(0), 8, 32)
    j_plain = JDatabase.build(data, JConfig(w=4))
    t_plain = Database.build(data, SearchConfig(w=4), device="cpu")
    q = queries(1, M)[0]
    cases = [
        ("plain", data[0], dict(mode="anytime")),
        ("tier", q, dict(mode="anytime", driver="scan")),
        ("tier", queries(1, 17)[0], dict(mode="anytime")),
        ("tier", q, dict(mode="anytime", budget=0)),
        ("tier", q, dict(mode="anytime", k=10**6)),
        ("tier", q, dict(budget=8)),
        ("tier", q, dict(mode="bogus")),
    ]
    engines = {name: (QueryEngine(t, start=False), JQueryEngine(j, start=False))
               for name, t, j in (("plain", t_plain, j_plain), ("tier", tdb, jdb))}
    texts = set()
    for name, query, kw in cases:
        t_eng, j_eng = engines[name]
        got = raised(lambda: t_eng.submit(query, **kw))
        assert got == raised(lambda: j_eng.submit(query, **kw)), kw
        assert got[0] is ValueError
        texts.add(got[1])
    assert len(texts) == len(cases)
    for t_eng, j_eng in engines.values():
        assert t_eng.stats().submitted == j_eng.stats().submitted == 0


def test_one_rank_mesh_is_served_on_the_anytime_path():
    data = random_walks(np.random.default_rng(3), N_DB, N)
    db = Database.build(data, SearchConfig(w=W, p=1, k=K), anytime=OPTS, device="cpu")
    qs = queries(2, M, seed=23)
    mesh = make_host_mesh(device="cpu")
    try:
        db.use_mesh(mesh)
        assert mesh.size == 1
        with QueryEngine(db, **ENGINE) as engine:
            futures = [engine.submit(q, mode="anytime", budget=b)
                       for q in qs for b in (None, 30)]
            answers = [f.result(timeout=60) for f in futures]
        for (q, b), a in zip([(q, b) for q in qs for b in (None, 30)], answers):
            direct = db.search(q, mode="anytime", budget=b)
            for f in ("distances", "indices", "error_bounds"):
                assert bits_equal(getattr(a, f), getattr(direct, f)), f
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_multi_rank_mesh_refused_on_the_anytime_path():
    """A stand-in mesh of two ranks (only its size is read) attached after
    construction fails the anytime request with the ``RuntimeError`` that
    names the fix instead of searching."""
    data = random_walks(np.random.default_rng(3), N_DB, N)
    db = Database.build(data, SearchConfig(w=W, p=1, k=K), anytime=OPTS, device="cpu")
    engine = QueryEngine(db, max_batch=2, max_wait_ms=0.0, start=False)
    try:
        fut = engine.submit(queries(1, M)[0], mode="anytime", budget=16)
        db.mesh = types.SimpleNamespace(size=2)
        engine.start()
        with pytest.raises(RuntimeError, match="make the engine after use_mesh"):
            fut.result(timeout=60)
    finally:
        engine.close()
    s = engine.stats()
    assert (s.served, s.anytime_served, s.batches, s.residual_bound_mean) == (0, 0, 0, 0.0)
