"""repro_torch's serving engine (CPU): the cases of ``tests/test_serve.py``
on the port.

The engine adds zero numeric surface: every answer — coalesced into a
microbatch, deduplicated onto another request's lane, or served from
the answer cache — must be bit-identical to the port's direct
``db.search`` / ``db.stream`` result.  The policy layer (admission
bounds, deadlines, LRU eviction, stale-config isolation) is tested
against its contracts.  One engine answer is also held against
``repro``'s engine on the same rows: the same indices, distances within
rtol 2e-4.
"""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.api import Database as JDatabase  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro.launch import serve as j_cli  # noqa: E402
from repro.serve import QueryEngine as JQueryEngine  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.core.microbatch import pad_rows  # noqa: E402
from repro_torch.data.synthetic import random_walks  # noqa: E402
from repro_torch.launch import serve as t_cli  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionFull,
    AnswerCache,
    DeadlineExceeded,
    QueryEngine,
)

torch.set_num_threads(1)

N_DB, LENGTH, W, BLOCK = 48, 32, 4, 16


def make_db(p, znorm=False, w=W):
    rng = np.random.default_rng(3)
    data = random_walks(rng, N_DB, LENGTH)
    return Database.build(data, SearchConfig(w=w, p=p, block=BLOCK, znorm=znorm),
                          device="cpu")


def queries_for(db, n=7, seed=11):
    rng = np.random.default_rng(seed)
    return random_walks(rng, n, db.length)


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("p", [1, 2, np.inf])
def test_engine_answers_bit_match_direct_search(p):
    db = make_db(p)
    qs = queries_for(db)
    with QueryEngine(db, max_batch=4, max_wait_ms=1.0) as engine:
        futures = [engine.submit(q) for q in qs]
        answers = [f.result(timeout=60) for f in futures]
    batch = db.search(qs)
    for i, (q, ans) in enumerate(zip(qs, answers)):
        direct = db.search(q)
        assert np.array_equal(ans.distances, direct.distances)
        assert np.array_equal(ans.indices, direct.indices)
        assert np.array_equal(ans.distances, batch.distances[i])
        assert not ans.cache_hit


def test_engine_answer_matches_repro_engine():
    """The port's engine and repro's on the same rows and queries: the same
    indices, distances within rtol 2e-4."""
    rng = np.random.default_rng(3)
    data = random_walks(rng, N_DB, LENGTH)
    qs = queries_for(make_db(1), n=3)
    tdb = Database.build(data, SearchConfig(w=W, p=1, k=2, block=BLOCK), device="cpu")
    jdb = JDatabase.build(data, JConfig(w=W, p=1, k=2, block=BLOCK))
    with QueryEngine(tdb, max_batch=4, max_wait_ms=1.0) as te:
        got = [te.submit(q).result(timeout=60) for q in qs]
    with JQueryEngine(jdb, max_batch=4, max_wait_ms=1.0) as je:
        want = [je.submit(q).result(timeout=120) for q in qs]
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.indices, np.asarray(w_.indices))
        np.testing.assert_allclose(g.distances, np.asarray(w_.distances), rtol=2e-4)


def test_engine_k_override_parity():
    db = make_db(1)
    q = queries_for(db, n=1)[0]
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5) as engine:
        ans = engine.search(q, k=3)
    direct = db.search(q, k=3)
    assert ans.distances.shape == (3,)
    assert np.array_equal(ans.distances, direct.distances)
    assert np.array_equal(ans.indices, direct.indices)


def test_concurrent_tenants_parity_and_accounting():
    db = make_db(2)
    qs = queries_for(db, n=12)
    direct = db.search(qs)
    results = {}
    lock = threading.Lock()
    with QueryEngine(db, max_batch=4, max_wait_ms=2.0) as engine:

        def client(name, idxs):
            futs = [(i, engine.submit(qs[i], tenant=name)) for i in idxs]
            for i, f in futs:
                r = f.result(timeout=60)
                with lock:
                    results[i] = r

        threads = [
            threading.Thread(target=client, args=(f"t{c}", range(c, 12, 3)))
            for c in range(3)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = engine.stats()
    assert len(results) == 12
    for i, r in results.items():
        assert np.array_equal(r.distances, direct.distances[i]), i
        assert np.array_equal(r.indices, direct.indices[i]), i
    assert stats.submitted == 12
    assert stats.served == 12
    assert stats.queue_depth == 0
    assert 0 < stats.batch_occupancy <= 1.0
    assert stats.anytime_served == 0 and stats.clusters_explored == 0


# ------------------------------------------------------------------- cache


def test_cache_hit_is_bit_identical_and_free():
    db = make_db(np.inf)
    q = queries_for(db, n=1)[0]
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5) as engine:
        cold = engine.search(q)
        warm = engine.search(q)
        stats = engine.stats()
    assert not cold.cache_hit and warm.cache_hit
    assert warm.batch_lanes == 0 and warm.wait_ms == 0.0
    assert np.array_equal(warm.distances, cold.distances)
    assert np.array_equal(warm.indices, cold.indices)
    direct = db.search(q)
    assert np.array_equal(warm.distances, direct.distances)
    assert stats.cache_hits == 1 and stats.batches == 1


def test_znormed_scaled_duplicate_hits_cache():
    """Under z-norm the digest is over the normalized bytes, so an
    exactly-representable rescaling of a served query is a hit."""
    db = make_db(1, znorm=True)
    q = queries_for(db, n=1)[0]
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5) as engine:
        cold = engine.search(q)
        warm = engine.search(q * 2.0)  # power-of-two scale: bit-stable
    assert warm.cache_hit
    assert np.array_equal(warm.distances, cold.distances)
    with QueryEngine(make_db(1, znorm=False), max_batch=2, max_wait_ms=0.5) as engine:
        engine.search(q)
        miss = engine.search(q * 2.0)
    assert not miss.cache_hit


def test_cache_eviction_respects_capacity():
    cache = AnswerCache(capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    cache.put("c", 3)  # evicts "a" (LRU)
    assert len(cache) == 2 and cache.evictions == 1
    assert cache.get("a") is None
    assert cache.get("b") == 2 and cache.get("c") == 3
    cache.put("b", 20)  # refreshing "b" makes "c" the LRU victim
    cache.put("d", 4)
    assert cache.get("c") is None and cache.get("b") == 20
    off = AnswerCache(capacity=0)
    off.put("x", 1)
    assert len(off) == 0 and off.get("x") is None
    with pytest.raises(ValueError):
        AnswerCache(capacity=-1)


def test_engine_cache_eviction_end_to_end():
    db = make_db(1)
    qs = queries_for(db, n=3)
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5, cache_capacity=2) as eng:
        for q in qs:  # 3 distinct digests through a 2-entry cache
            eng.search(q)
        again = eng.search(qs[0])  # evicted: must re-execute, same bits
    assert not again.cache_hit
    assert np.array_equal(again.distances, db.search(qs[0]).distances)


def test_stale_config_answers_never_served():
    """A cache shared between sessions keys on the session fingerprint."""
    rng = np.random.default_rng(3)
    data = random_walks(rng, N_DB, LENGTH)
    db_p1 = Database.build(data, SearchConfig(w=W, p=1, block=BLOCK), device="cpu")
    db_pinf = Database.build(data, SearchConfig(w=W, p=np.inf, block=BLOCK), device="cpu")
    assert db_p1.fingerprint != db_pinf.fingerprint
    shared = AnswerCache(capacity=16)
    q = queries_for(db_p1, n=1)[0]
    with QueryEngine(db_p1, max_batch=2, max_wait_ms=0.5, cache=shared) as e1:
        a1 = e1.search(q)
        assert e1.search(q).cache_hit
    with QueryEngine(db_pinf, max_batch=2, max_wait_ms=0.5, cache=shared) as e2:
        a2 = e2.search(q)
    assert not a2.cache_hit
    assert np.array_equal(a2.distances, db_pinf.search(q).distances)
    assert not np.array_equal(a1.distances, a2.distances)


def test_per_call_k_override_misses_other_k_entries():
    db = make_db(1)
    q = queries_for(db, n=1)[0]
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5) as engine:
        engine.search(q)
        assert not engine.search(q, k=2).cache_hit
        assert engine.search(q, k=2).cache_hit
        assert engine.search(q).cache_hit


# ---------------------------------------------------------------- coalesce


def test_identical_inflight_requests_share_one_lane():
    db = make_db(1)
    qs = queries_for(db, n=2)
    engine = QueryEngine(db, max_batch=4, max_wait_ms=1.0, start=False)
    futs = [engine.submit(qs[0]), engine.submit(qs[0]), engine.submit(qs[0]),
            engine.submit(qs[1])]
    engine.start()
    answers = [f.result(timeout=60) for f in futs]
    engine.close()
    direct0, direct1 = db.search(qs[0]), db.search(qs[1])
    for ans in answers[:3]:
        assert np.array_equal(ans.distances, direct0.distances)
    assert np.array_equal(answers[3].distances, direct1.distances)
    stats = engine.stats()
    assert stats.coalesced == 2
    assert stats.batches == 1 and stats.batch_lanes == 2
    assert sum(a.coalesced for a in answers) == 2


# --------------------------------------------------------------- admission


def test_admission_queue_backpressure():
    db = make_db(1)
    qs = queries_for(db, n=3)
    engine = QueryEngine(db, max_batch=2, max_wait_ms=0.5, max_queue=2, start=False)
    f0 = engine.submit(qs[0])
    f1 = engine.submit(qs[1])
    with pytest.raises(AdmissionFull):
        engine.submit(qs[2])
    f2 = engine.submit(qs[2], tenant="other")  # admission is per tenant
    engine.start()
    for f in (f0, f1, f2):
        f.result(timeout=60)
    engine.close()
    assert engine.stats().rejected == 1


def test_deadline_expires_queued_request():
    db = make_db(1)
    qs = queries_for(db, n=2)
    engine = QueryEngine(db, max_batch=2, max_wait_ms=0.5, start=False)
    doomed = engine.submit(qs[0], deadline=0.0)
    ok = engine.submit(qs[1], deadline=60.0)
    time.sleep(0.01)  # let the zero deadline lapse before the worker runs
    engine.start()
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=60)
    ans = ok.result(timeout=60)
    engine.close()
    assert np.array_equal(ans.distances, db.search(qs[1]).distances)
    assert engine.stats().expired == 1


def test_close_drains_pending_and_rejects_new():
    db = make_db(1)
    qs = queries_for(db, n=4)
    engine = QueryEngine(db, max_batch=2, max_wait_ms=50.0)
    futs = [engine.submit(q) for q in qs]
    engine.close()
    for q, f in zip(qs, futs):
        assert np.array_equal(f.result(timeout=1).distances, db.search(q).distances)
    with pytest.raises(RuntimeError):
        engine.submit(qs[0])


def test_anytime_mode_raises_item_10():
    """A session without the anytime tier refuses ``mode="anytime"`` with
    the reference engine's ``ValueError`` (type and text)."""
    db = make_db(1)
    q = queries_for(db, n=1)[0]
    jdb = JDatabase.build(db.raw, JConfig(w=W, p=1, block=BLOCK))
    with pytest.raises(ValueError) as want:
        JQueryEngine(jdb, max_batch=2, start=False).submit(q, mode="anytime")
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5) as engine:
        with pytest.raises(ValueError) as got:
            engine.submit(q, mode="anytime")
        assert str(got.value) == str(want.value)
        assert "needs the anytime tier" in str(got.value)
        with pytest.raises(ValueError):
            engine.submit(q, budget=3)
        with pytest.raises(ValueError):
            engine.submit(queries_for(db, n=2))  # a batch, not one query
        assert engine.stats().submitted == 0


# --------------------------------------------------------------- streaming


def test_stream_session_matches_direct_matcher():
    db = make_db(1, znorm=True)
    rng = np.random.default_rng(7)
    signal = random_walks(rng, 1, 300)[0]
    templates = db.raw[:2]
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5) as engine:
        sess = engine.open_stream(templates, threshold=4.0, hop=2)
        assert engine.stats().streams_open == 1
        hits = []
        for lo in range(0, signal.size, 100):
            hits += sess.feed(signal[lo : lo + 100])
        hits += sess.close()
        assert engine.stats().streams_open == 0
        assert engine.stats().stream_samples == signal.size
    ref = db.stream(templates, threshold=4.0, hop=2)
    ref.push(signal)
    ref.flush()
    assert sorted(hits, key=lambda m: (m.start, m.tid)) == ref.matches()


def test_stream_concurrent_with_queries():
    """A stream client thread feeds its session while tenant threads
    submit queries: the stream's matches are a direct matcher's, every
    answer a direct search's."""
    db = make_db(1)
    qs = queries_for(db, n=8)
    rng = np.random.default_rng(8)
    signal = random_walks(rng, 1, 400)[0]
    direct = db.search(qs)
    streamed, answers = [], {}
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5) as engine:
        sess = engine.open_stream(threshold=2.0)

        def stream_client():
            for lo in range(0, signal.size, 50):
                streamed.extend(sess.feed(signal[lo : lo + 50]))
            streamed.extend(sess.close())

        def query_client(idxs):
            for i in idxs:
                answers[i] = engine.submit(qs[i], tenant=f"t{i % 2}").result(timeout=60)

        threads = [threading.Thread(target=stream_client)] + [
            threading.Thread(target=query_client, args=(range(c, 8, 2),)) for c in range(2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    for i, ans in answers.items():
        assert np.array_equal(ans.distances, direct.distances[i])
        assert np.array_equal(ans.indices, direct.indices[i])
    ref = db.stream(threshold=2.0)
    ref.push(signal)
    ref.flush()
    assert sorted(streamed, key=lambda m: (m.start, m.tid)) == ref.matches()


# ------------------------------------------------------------- primitives


def test_pad_rows_shapes_and_validation():
    rows = [np.arange(4, dtype=np.float32) + i for i in range(3)]
    block, n_valid = pad_rows(rows, 5)
    assert block.shape == (5, 4) and n_valid == 3
    assert np.array_equal(block[3], rows[2]) and np.array_equal(block[4], rows[2])
    with pytest.raises(ValueError):
        pad_rows(rows, 2)


def test_serve_cli_runs_and_verifies(capsys, monkeypatch):
    """``repro_torch.launch.serve --device cpu`` serves the mixed workload,
    verifies every answer against a direct ``db.search`` and runs the
    stream session, as the reference's CLI does on the same flags; both
    print the same stream-session window count."""
    args = ["--db-size", "96", "--length", "32", "--queries", "12", "--stream-samples",
            "300"]
    t_cli.main(["--device", "cpu", *args])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *args])
    j_cli.main()
    ref = capsys.readouterr().out
    assert "answers verified bit-identical to direct db.search" in port

    def stream_tail(out):
        line = next(ln for ln in out.splitlines() if ln.startswith("stream session:"))
        return line.split(", ", 2)[-1]  # "<m> matches, windows=<w>"

    assert stream_tail(port) == stream_tail(ref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_cli.main(args)
