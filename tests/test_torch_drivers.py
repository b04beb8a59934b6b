"""repro_torch's scan and host drivers against repro.core.cascade (CPU).

Same database and queries through both packages, for Q in {1, 8}, k in
{1, 5}, a ragged last block (200 rows in blocks of 32) and all six
univariate methods: equal top-k indices, distances within rtol 2e-4
(float32) and equal ``SearchStats``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import cascade as jcas  # noqa: E402
from repro.core.microbatch import drain_queries as j_drain  # noqa: E402
from repro_torch.core import cascade as tcas  # noqa: E402
from repro_torch.core.classify import classification_accuracy, nn_classify  # noqa: E402
from repro_torch.core.microbatch import drain_queries, iter_query_batches  # noqa: E402

torch.set_num_threads(1)

METHODS = ["full", "lb_keogh", "lb_improved", "lb_webb", "kim_improved", "kim_webb"]
N_DB, N, W = 200, 40, 4


def data(seed=0, nq=8):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(N_DB, N)).astype(np.float32).cumsum(axis=1)
    qs = rng.normal(size=(nq, N)).astype(np.float32).cumsum(axis=1)
    return db, qs


def stats_key(s):
    return (s.n_candidates, s.full_dtw, s.stage_names, tuple(s.stage_pruned),
            s.blocks_total, s.blocks_lb2, s.blocks_dtw, s.dp_lane_work,
            s.dp_lane_useful)


def assert_same(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.indices), tres.indices)
    np.testing.assert_allclose(tres.distances, np.asarray(jres.distances), rtol=2e-4)
    assert stats_key(jres.stats) == stats_key(tres.stats)
    for js, ts in zip(getattr(jres, "per_query", ()), getattr(tres, "per_query", ())):
        assert stats_key(js) == stats_key(ts)


CASES = [(8, 5), (1, 1)]


@pytest.mark.parametrize("nq,k", CASES)
@pytest.mark.parametrize("method", METHODS)
def test_scan_driver_matches_jax(method, nq, k):
    db, qs = data(1)
    q = qs[:nq] if nq > 1 else qs[0]
    jres = jcas.nn_search_scan(q, db, W, 1, k, 32, method)
    tres = tcas.nn_search_scan(q, db, W, 1, k, 32, method, device="cpu")
    assert isinstance(tres, tcas.SearchResult if nq == 1 else tcas.BatchSearchResult)
    assert_same(jres, tres)


@pytest.mark.parametrize("nq,k", CASES)
@pytest.mark.parametrize("method", METHODS)
def test_host_driver_matches_jax(method, nq, k):
    db, qs = data(2)
    q = qs[:nq] if nq > 1 else qs[0]
    jres = jcas.nn_search_host(q, db, W, 1, k, 32, 16, method)
    tres = tcas.nn_search_host(q, db, W, 1, k, 32, 16, method, device="cpu")
    assert_same(jres, tres)


@pytest.mark.parametrize("p", [2, math.inf])
@pytest.mark.parametrize("driver", ["scan", "host"])
def test_drivers_other_norms(driver, p):
    db, qs = data(3)
    if driver == "scan":
        jres = jcas.nn_search_scan(qs, db, W, p, 5, 32, "lb_improved")
        tres = tcas.nn_search_scan(qs, db, W, p, 5, 32, "lb_improved", device="cpu")
    else:
        jres = jcas.nn_search_host(qs, db, W, p, 5, 32, 16, "lb_improved")
        tres = tcas.nn_search_host(qs, db, W, p, 5, 32, 16, "lb_improved", device="cpu")
    assert_same(jres, tres)


def test_host_driver_early_abandon_matches_jax():
    db, qs = data(4)
    jres = jcas.nn_search_host(qs, db, W, 1, 3, 32, 16, "lb_improved", early_abandon=True)
    tres = tcas.nn_search_host(qs, db, W, 1, 3, 32, 16, "lb_improved",
                               early_abandon=True, device="cpu")
    assert_same(jres, tres)


def test_scan_and_host_agree_and_tensor_inputs():
    db, qs = data(5)
    a = tcas.nn_search_scan(torch.as_tensor(qs), torch.as_tensor(db), W, k=4)
    b = tcas.nn_search_host(qs, db, W, k=4, block=64, device="cpu")
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6)
    assert a.stats.n_candidates == b.stats.n_candidates == 8 * N_DB
    for s in (a.stats, b.stats):
        assert sum(s.stage_pruned) + s.full_dtw == s.n_candidates


def test_drivers_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db, qs = data(6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcas.nn_search_scan(qs, db, W)
    # rows of 2 channels: the host driver serves them (the multivariate
    # tier), with the reference's answers and counters
    assert_same(jcas.nn_search_host(qs, db, W, d=2),
                tcas.nn_search_host(qs, db, W, d=2, device="cpu"))


def test_microbatch_and_classify():
    db, qs = data(7, nq=5)
    got = list(drain_queries(
        qs, lambda b: tcas.nn_search_scan(b, db, W, k=2, device="cpu"), 2))
    want = list(j_drain(qs, lambda b: jcas.nn_search_scan(b, db, W, k=2), 2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.indices, np.asarray(w.indices))
    assert [nv for _, nv in iter_query_batches(qs, 2)] == [2, 2, 1]
    labels = np.arange(N_DB) % 3
    pred = nn_classify(qs[0], db, labels, W, device="cpu")
    assert pred == labels[got[0].index]
    acc = classification_accuracy(db[:6], labels[:6], db, labels, W, device="cpu")
    assert acc == 1.0  # every row is its own nearest neighbour
