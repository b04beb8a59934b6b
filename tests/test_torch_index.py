"""repro_torch's stage-0 triangle index against repro.index (CPU).

The same numpy inputs, made from a seed, go through both packages:

* the bounds of ``index/triangle_lb.py`` and ``powered``; the metric
  tools of ``core/metrics.py``;
* ``cluster_from_distances``, ``select_references`` and ``build_index``;
* the ``.npz`` interchange, both ways;
* ``nn_search_indexed`` on the reference's index (loaded through the
  interchange, so a difference in the build cannot hide a difference in
  the search): the same indices, distances within rtol 2e-4 and equal
  counters, at p in {1, 2, inf};
* the reference's own index cases, and one float64 case (the JAX side in
  a subprocess with x64 enabled only there).

Bits of the stage-0 bounds: ``repro``'s jitted ``lb_triangle_batch`` and
``lb_triangle_clusters`` are compiled by XLA, which turns ``x / c`` into
``x * (1 / c)`` and contracts some of the subtractions into fused
multiply-adds, varying with the shape (ROADMAP.md queue 3, E).  The port
divides.  So at finite p those two are held bit-equal to the formula as
written (numpy float32) and within a few float32 ulps of the operands to
``repro``; at p = inf (c = 1) and for the eager ``lb_triangle_pair`` and
``triangle_lower_bound`` they are bit-equal to ``repro``.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from helpers import run_in_subprocess  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core.cascade import nn_search_indexed as j_search  # noqa: E402
from repro.index import build_index as j_build  # noqa: E402
from repro.index import cluster_from_distances as j_cluster  # noqa: E402
from repro.index import select_references as j_select  # noqa: E402
from repro.index import store as j_store  # noqa: E402
from repro.index import triangle_lb as j_tri  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core.cascade import nn_search_indexed as t_search  # noqa: E402
from repro_torch.core.cascade import nn_search_scan as t_scan  # noqa: E402
from repro_torch.index import build_index as t_build  # noqa: E402
from repro_torch.index import cluster_from_distances as t_cluster  # noqa: E402
from repro_torch.index import select_references as t_select  # noqa: E402
from repro_torch.index import store as t_store  # noqa: E402
from repro_torch.index import triangle_lb as t_tri  # noqa: E402

torch.set_num_threads(1)

N_DB, LENGTH, W, R, NQ = 160, 48, 5, 7, 3
P_ALL = [1, 2, math.inf]
EPS32 = float(np.finfo(np.float32).eps)


def walks(seed, rows, n=LENGTH):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


X = walks(1, N_DB)
QS = walks(2, NQ)


def jp(p):
    return jnp.inf if p == math.inf else p


@pytest.fixture(scope="module")
def jindex():
    """The reference's index over X, one per p, built once (each new
    shape costs a JAX compile)."""
    cache = {}

    def get(p):
        if p not in cache:
            cache[p] = j_build(X, W, jp(p), n_refs=R)
        return cache[p]

    return get


def port_index(jidx):
    """The reference's index in the port, through the .npz arrays."""
    return t_store.index_from_arrays(j_store.index_arrays(jidx))


# ------------------------------------------------------------ the bounds


@pytest.mark.parametrize("p", P_ALL, ids=str)
def test_triangle_bounds_match_reference(p):
    rng = np.random.default_rng(11)
    dq, dqw = (rng.random((2, NQ, R)) * 10).astype(np.float32)
    drd, drdw = (rng.random((2, R, N_DB)) * 10).astype(np.float32)
    rad, mrw = rng.random(R) * 3, rng.random(R) * 10
    c = jmetrics.theorem1_bound(LENGTH, W, jp(p))
    assert tmetrics.theorem1_bound(LENGTH, W, p) == c

    for arr in (dq, drd):
        np.testing.assert_array_equal(
            t_tri.powered(torch.tensor(arr), p).numpy(),
            np.asarray(j_tri.powered(jnp.asarray(arr), jp(p))),
        )
    np.testing.assert_array_equal(
        t_tri.lb_triangle_pair(torch.tensor(dqw), torch.tensor(dq), c).numpy(),
        np.asarray(j_tri.lb_triangle_pair(jnp.asarray(dqw), jnp.asarray(dq), c)),
    )

    # the formula as written, in float32 numpy
    c32, zero, slack = np.float32(c), np.float32(0), np.float32(t_tri.SLACK)
    rad32, mrw32 = rad.astype(np.float32), mrw.astype(np.float32)
    want_batch = (np.maximum(np.maximum(dqw[:, :, None] / c32 - drd, drdw / c32 - dq[:, :, None]),
                             zero) * slack).max(axis=1)
    want_cl = np.maximum(np.maximum(dqw / c32 - rad32, mrw32 / c32 - dq), zero) * slack
    got_batch = t_tri.lb_triangle_batch(*map(torch.tensor, (dq, dqw, drd, drdw)), c).numpy()
    # the radii take the session's dtype, as in nn_search_indexed
    got_cl = t_tri.lb_triangle_clusters(
        torch.tensor(dq), torch.tensor(dqw), torch.tensor(rad32), torch.tensor(mrw32), c
    ).numpy()
    np.testing.assert_array_equal(got_batch, want_batch)
    np.testing.assert_array_equal(got_cl, want_cl)

    ref_batch = np.asarray(j_tri.lb_triangle_batch(*map(jnp.asarray, (dq, dqw, drd, drdw)), c))
    ref_cl = np.asarray(j_tri.lb_triangle_clusters(
        jnp.asarray(dq), jnp.asarray(dqw), jnp.asarray(rad), jnp.asarray(mrw), c))
    if p == math.inf:
        np.testing.assert_array_equal(got_batch, ref_batch)
        np.testing.assert_array_equal(got_cl, ref_cl)
    else:
        # XLA's reciprocal and fused multiply-adds: a few ulps of the operands
        np.testing.assert_allclose(got_batch, ref_batch, rtol=0, atol=4 * EPS32 * 10)
        np.testing.assert_allclose(got_cl, ref_cl, rtol=0, atol=4 * EPS32 * 10)
    # a batch of one query and a single (R,) query give the same rows
    np.testing.assert_array_equal(
        t_tri.lb_triangle_batch(*map(torch.tensor, (dq[0], dqw[0], drd, drdw)), c).numpy(),
        got_batch[0],
    )


@pytest.mark.parametrize("p", P_ALL, ids=str)
def test_metrics_match_reference(p):
    for n, w in ((48, 5), (10, 20), (1000, 100)):
        assert tmetrics.theorem1_bound(n, w, p) == jmetrics.theorem1_bound(n, w, jp(p))
    rng = np.random.default_rng(12)
    d_wide, d_w = (rng.random((2, 5, 9)) * 10).astype(np.float32)
    np.testing.assert_array_equal(
        tmetrics.triangle_lower_bound(torch.tensor(d_wide), torch.tensor(d_w), LENGTH, W, p).numpy(),
        np.asarray(jmetrics.triangle_lower_bound(d_wide, d_w, LENGTH, W, jp(p))),
    )
    x, y, z = X[:3]
    np.testing.assert_allclose(
        tmetrics.triangle_ratio(x, y, z, W, p, device="cpu").numpy(),
        np.asarray(jmetrics.triangle_ratio(x, y, z, W, jp(p))), rtol=3e-4,
    )
    series = X[:24]
    tf, tr = tmetrics.violation_fraction(series, np.random.default_rng(5), 16, 2, p,
                                         device="cpu")
    jf, jr = jmetrics.violation_fraction(jnp.asarray(series), np.random.default_rng(5), 16, 2,
                                         jp(p))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=3e-4)
    assert tf == pytest.approx(jf, rel=3e-4)


# ---------------------------------------------------------- the build


@pytest.mark.parametrize("exclude", [False, True], ids=["all_cols", "exclude_refs"])
def test_cluster_from_distances_bit_equal(jindex, exclude):
    jidx = jindex(1)
    cols = jidx.ref_idx if exclude else None
    for n_clusters in (None, 4):
        a = j_cluster(jidx.d_ref_db, n_clusters, jidx.d_ref_db_wide, exclude_cols=cols)
        b = t_cluster(jidx.d_ref_db, n_clusters, jidx.d_ref_db_wide, exclude_cols=cols)
        for field in ("rep_rows", "assign", "radii", "min_radii_wide", "d_rep_member"):
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
        assert b.n_clusters == a.n_clusters
    with pytest.raises(ValueError, match="n_clusters"):
        t_cluster(jidx.d_ref_db, R + 1)


@pytest.mark.parametrize("p", P_ALL, ids=str)
def test_build_index_matches_reference(jindex, p):
    jidx = jindex(p)
    tidx = t_build(X, W, p, n_refs=R, device="cpu")
    np.testing.assert_array_equal(tidx.ref_idx, jidx.ref_idx)
    np.testing.assert_array_equal(tidx.clustering.assign, jidx.clustering.assign)
    np.testing.assert_array_equal(tidx.ref_series, jidx.ref_series)
    np.testing.assert_allclose(tidx.d_ref_db, jidx.d_ref_db, rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(tidx.d_ref_db_wide, jidx.d_ref_db_wide, rtol=3e-4, atol=1e-6)
    assert tidx.d_ref_db.dtype == jidx.d_ref_db.dtype == np.float32
    assert (tidx.w, tidx.p, tidx.n, tidx.n_db, tidx.digest) == (
        jidx.w, jidx.p, jidx.n, jidx.n_db, jidx.digest)
    assert (tidx.constant, tidx.w_wide) == (jidx.constant, jidx.w_wide)
    np.testing.assert_array_equal(tidx.rep_idx, jidx.rep_idx)


def test_select_references_random_and_validation():
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    ji, jd = j_select(X, 4, W, 1, strategy="random", rng=rng_j)
    ti, td = t_select(X, 4, W, 1, strategy="random", rng=rng_t, device="cpu")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=3e-4, atol=1e-6)
    for bad, match in ((dict(n_refs=0), "n_refs"), (dict(n_refs=N_DB + 1), "n_refs"),
                       (dict(n_refs=2, strategy="nope"), "strategy")):
        with pytest.raises(ValueError, match=match):
            t_select(X, w=W, device="cpu", **bad)


def test_npz_interchange_both_ways(jindex, tmp_path):
    jidx = jindex(2)
    tidx = t_build(X, W, 2, n_refs=R, device="cpu")
    # the port's index loads in repro, the reference's in the port
    from_port = j_store.load_index(t_store.save_index(tidx, str(tmp_path / "port")))
    from_ref = t_store.load_index(j_store.save_index(jidx, str(tmp_path / "ref")))
    for src, dst in ((tidx, from_port), (jidx, from_ref)):
        a, b = j_store.index_arrays(src), t_store.index_arrays(dst)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]))
            assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype, key
    # a 4-slot meta (before the channel count) loads as d = 1
    arrays = t_store.index_arrays(tidx)
    arrays["meta"] = arrays["meta"][:4]
    assert t_store.index_from_arrays(arrays).d == 1
    np.savez(tmp_path / "v9.npz", format_version=np.int64(9), **t_store.index_arrays(tidx))
    with pytest.raises(ValueError, match="unsupported"):
        t_store.load_index(str(tmp_path / "v9.npz"))


# ---------------------------------------------------------- the search

STATS_FIELDS = (
    "n_candidates", "stage_names", "stage_pruned", "full_dtw", "lb0_pruned", "ref_dtw",
    "clusters_total", "clusters_pruned", "blocks_total", "blocks_lb2", "blocks_dtw",
    "dp_lane_work", "dp_lane_useful", "lb1_pruned", "lb2_pruned", "pruning_ratio",
    "stage0_ratio", "dp_lane_efficiency",
)


def same_search(jres, tres, rtol=2e-4):
    np.testing.assert_array_equal(np.asarray(jres.indices), tres.indices)
    np.testing.assert_allclose(tres.distances, np.asarray(jres.distances), rtol=rtol)
    pairs = [(jres.stats, tres.stats)]
    pairs += list(zip(getattr(jres, "per_query", ()), getattr(tres, "per_query", ())))
    for a, b in pairs:
        assert {f: getattr(b, f) for f in STATS_FIELDS} == {f: getattr(a, f)
                                                             for f in STATS_FIELDS}


def accounted(stats):
    return stats.lb0_pruned + sum(stats.stage_pruned) + stats.full_dtw == stats.n_candidates


SEARCH_CASES = [(p, k, "lb_improved") for p in P_ALL for k in (1, 3)]
SEARCH_CASES += [(1, 1, "lb_keogh"), (1, 1, "full")]


@pytest.mark.parametrize("p,k,method", SEARCH_CASES, ids=lambda v: str(v))
def test_indexed_search_matches_reference(jindex, p, k, method):
    jidx = jindex(p)
    tidx = port_index(jidx)
    jres = j_search(QS, X, jidx, k=k, method=method)
    tres = t_search(QS, X, tidx, k=k, method=method, device="cpu")
    same_search(jres, tres)
    assert all(accounted(s) for s in (tres.stats, *tres.per_query))
    assert tres.stats.ref_dtw == NQ * 2 * R
    assert tres.stats.clusters_total == NQ * R
    # and exact: the scan driver finds the same neighbours
    scan = t_scan(QS, X, W, p, k=k, device="cpu")
    np.testing.assert_array_equal(np.sort(tres.indices, axis=1), np.sort(scan.indices, axis=1))


CASES = ["foreign_database", "query_is_reference", "k_above_refs", "accounting"]


@pytest.mark.parametrize("case", CASES)
def test_reference_index_cases(jindex, case):
    """The reference's own index tests (tests/test_index.py), in the port."""
    if case == "foreign_database":
        tidx = port_index(jindex(1))
        other = X + 1.0
        with pytest.raises(ValueError, match="different database"):
            t_search(QS[0], other, tidx, device="cpu")
        with pytest.raises(ValueError, match="different database"):
            tidx.validate_data(other)
        tidx.validate_data(X)  # the right database passes
        with pytest.raises(ValueError, match="index built for"):
            tidx.validate(N_DB, LENGTH, W + 1, 1)  # wrong w
        with pytest.raises(ValueError, match="index built for"):
            t_search(QS, X[:-1], tidx, device="cpu")  # wrong database size
    elif case == "query_is_reference":
        jidx = jindex(math.inf)
        ref = int(jidx.ref_idx[0])
        tres = t_search(X[ref], X, port_index(jidx), device="cpu")
        assert tres.index == ref
        assert tres.distance == pytest.approx(0.0, abs=1e-5)
        same_search(j_search(X[ref], X, jidx), tres)
    elif case == "k_above_refs":
        jidx = jindex(1)
        k = R + 2
        tres = t_search(QS[0], X, port_index(jidx), k=k, device="cpu")
        same_search(j_search(QS[0], X, jidx, k=k), tres)
        scan = t_scan(QS[0], X, W, 1, k=k, device="cpu")
        assert set(tres.indices.tolist()) == set(scan.indices.tolist())
    else:
        tres = t_search(QS, X, port_index(jindex(math.inf)), device="cpu")
        s = tres.stats
        assert s.n_candidates == NQ * N_DB and s.ref_dtw == NQ * 2 * R
        assert s.lb0_pruned + s.lb1_pruned + s.lb2_pruned + s.full_dtw == s.n_candidates
        assert all(q.full_dtw >= R for q in tres.per_query)  # references pay the DP
        assert s.lb0_pruned > 0  # at p = inf (c = 1) stage 0 prunes random walks
        assert 0.0 < s.stage0_ratio <= 1.0
        assert s.blocks_total & (s.blocks_total - 1) == 0  # a power of two


def test_float64_indexed_search_matches_repro_x64(tmp_path):
    """precision float64: the JAX side builds its index and searches with
    x64 in a subprocess (never in this process); the port searches the
    same index (through .npz) in float64.  Indices and counters equal,
    distances within 1e-12."""
    x = walks(21, 90, 32).astype(np.float64)
    q = walks(22, 3, 32).astype(np.float64)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "q.npy", q)
    code = f"""
import json, numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro.core.cascade import nn_search_indexed
from repro.index import build_index, save_index
x = np.load({str(tmp_path / "x.npy")!r}); q = np.load({str(tmp_path / "q.npy")!r})
idx = build_index(x, 3, 2, n_refs=5)
save_index(idx, {str(tmp_path / "idx")!r})
r = nn_search_indexed(q, x, idx, k=2)
print(json.dumps({{"i": np.asarray(r.indices).tolist(), "d": np.asarray(r.distances).tolist(),
                  "dt": str(np.asarray(r.distances).dtype),
                  "s": [[*s.stage_pruned, s.full_dtw, s.lb0_pruned, s.clusters_pruned,
                         s.blocks_total, s.blocks_lb2, s.blocks_dtw, s.dp_lane_work,
                         s.dp_lane_useful] for s in r.per_query]}}))
"""
    out = json.loads(run_in_subprocess(code, n_devices=1).strip().splitlines()[-1])
    tidx = t_store.load_index(str(tmp_path / "idx"))
    res = t_search(q, x, tidx, k=2, device="cpu")
    assert out["dt"] == "float64" and res.distances.dtype == np.float64
    np.testing.assert_array_equal(res.indices, np.asarray(out["i"]))
    np.testing.assert_allclose(res.distances, np.asarray(out["d"]), rtol=1e-12)
    got = [[*s.stage_pruned, s.full_dtw, s.lb0_pruned, s.clusters_pruned, s.blocks_total,
            s.blocks_lb2, s.blocks_dtw, s.dp_lane_work, s.dp_lane_useful] for s in res.per_query]
    assert got == out["s"]
    # the port's own float64 build picks the same references
    np.testing.assert_array_equal(t_build(x, 3, 2, n_refs=5, device="cpu").ref_idx, tidx.ref_idx)
