"""repro_torch's anytime tier, build side, against repro.anytime (CPU).

The same seeded numpy inputs go through both packages: window slicing
and PAA sketches bit-equal; farthest-first, the assignment and the boxes
bit-equal; every index array and box of the cluster tree bit-equal at p
in {1, 2, inf}, the DTW radii within rtol 3e-4 (the DP's tolerance in
``tests/test_kernels.py``: the port's radii are ``dtw_qbatch_op``'s, the
plain version on CPU tensors); the same validation errors; ``any_*``
bundle arrays with the reference's keys and dtypes, loading both ways;
``Database.build(anytime=...)`` with the reference's ``repr`` and an
exact search equal to the session without the tier.  The search side is
held in ``tests/test_torch_anytime_search.py`` and its serving in
``tests/test_torch_serve_anytime.py``; here, what still raises.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import anytime as J  # noqa: E402
from repro.anytime.build import default_hop as j_default_hop  # noqa: E402
from repro.anytime.cluster import _assign as j_assign  # noqa: E402
from repro.anytime.cluster import _box as j_box  # noqa: E402
from repro.api import Database as JDatabase  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro_torch import anytime as T  # noqa: E402
from repro_torch.anytime.build import default_hop  # noqa: E402
from repro_torch.anytime.cluster import _assign, _box, _rep_dists  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.kernels.dtw.ops import dtw_plain  # noqa: E402
from repro_torch.serve import QueryEngine  # noqa: E402

N_DB, N, M, HOP, W = 24, 64, 16, 4, 6
P_VALUES = [1, 2, math.inf]
TREE_INDEX = ("rep_gid", "leaf_start", "member_start", "members")
TREE_BOXES = ("cmin0", "cmax0", "cmin1", "cmax1")
RADII = ("radii_w", "min_radii_wide")
OPTS = dict(lengths=(M, N), hop=HOP, leaf_size=8)


def walks(seed, rows, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


DATA = walks(3, N_DB, N)


def bank(m=M, hop=HOP, znorm=False):
    wins, _, _ = J.slice_windows(DATA, m, hop, znorm=znorm)
    return wins, J.paa_sketch(wins, min(16, m))


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def same_tree(t, j):
    for f in TREE_INDEX + TREE_BOXES:
        assert bits_equal(getattr(t, f), getattr(j, f)), f
    for f in RADII:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=3e-4, err_msg=f)


def same_index(t, j):
    assert t.lengths == j.lengths and t.p == j.p and t.znorm == j.znorm
    assert repr(t) == repr(j)
    assert (t.n_windows, t.n_clusters) == (j.n_windows, j.n_clusters)
    for m in j.lengths:
        a, b = t.tier(m), j.tier(m)
        assert (a.m, a.hop, a.w, a.n_windows) == (b.m, b.hop, b.w, b.n_windows)
        assert isinstance(a.wins, torch.Tensor)
        assert bits_equal(a.wins.cpu().numpy(), b.wins)
        assert bits_equal(a.row_ids, b.row_ids) and bits_equal(a.starts, b.starts)
        same_tree(a.tree, b.tree)


def raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


# ------------------------------------------------------------- slices


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("hop", [1, 3])
@pytest.mark.parametrize("znorm", [False, True])
def test_slice_windows_bit_equal(znorm, hop, dtype):
    got = T.slice_windows(DATA, M, hop, znorm=znorm, dtype=dtype)
    want = J.slice_windows(DATA, M, hop, znorm=znorm, dtype=dtype)
    for g, w in zip(got, want):
        assert bits_equal(g, w)


@pytest.mark.parametrize("args", [(DATA[0], M, 1), (DATA, 0, 1), (DATA, N + 1, 1),
                                  (DATA, M, 0)], ids=["1d", "m0", "m_past_n", "hop0"])
def test_slice_windows_errors(args):
    assert raised(lambda: T.slice_windows(*args)) == raised(lambda: J.slice_windows(*args))


@pytest.mark.parametrize("dim", [1, 5, 16, 64, 80])
def test_paa_sketch_bit_equal(dim):
    wins, _, _ = J.slice_windows(DATA, N, 1)
    assert bits_equal(T.paa_sketch(wins, dim), J.paa_sketch(wins, dim))


def test_paa_sketch_error():
    wins, _ = bank()
    assert raised(lambda: T.paa_sketch(wins, 0)) == raised(lambda: J.paa_sketch(wins, 0))


# ------------------------------------------------------------ cluster


@pytest.mark.parametrize("seed", [0, 7])
def test_farthest_first_assign_and_box_equal(seed):
    wins, sketch = bank()
    centers = T.farthest_first(sketch, 17, seed)
    assert bits_equal(centers, J.farthest_first(sketch, 17, seed))
    assert bits_equal(_assign(sketch, centers, chunk=50), j_assign(sketch, centers, chunk=50))
    for rows in (wins[centers], wins[:0]):
        for g, w in zip(_box(rows), j_box(rows)):
            assert bits_equal(g, w)


@pytest.mark.parametrize("p", P_VALUES)
def test_build_tree_matches_reference(p):
    wins, sketch = bank()
    kw = dict(n_coarse=17, leaf_size=8, w=W, p=p, seed=2)
    same_tree(T.build_tree(wins, sketch, device="cpu", **kw), J.build_tree(wins, sketch, **kw))


@pytest.mark.parametrize("n_coarse,leaf_size", [(1, 1000), (20, 1), (50, 4)],
                         ids=["one_cluster_one_leaf", "leaf_per_window", "every_window_a_rep"])
def test_build_tree_edges_match_reference(n_coarse, leaf_size):
    wins, sketch = bank(m=24, hop=40)  # 24 windows, one a row
    kw = dict(n_coarse=n_coarse, leaf_size=leaf_size, w=3, p=1)
    got = T.build_tree(wins, sketch, device="cpu", **kw)
    same_tree(got, J.build_tree(wins, sketch, **kw))
    everything = np.sort(np.concatenate([got.rep_gid, got.members]))
    assert np.array_equal(everything, np.arange(wins.shape[0]))


def test_build_tree_on_an_empty_bank_raises_as_the_reference():
    wins = np.zeros((0, 8), np.float32)
    assert raised(lambda: T.build_tree(wins, wins, n_coarse=2, leaf_size=2, w=1, p=1,
                                       device="cpu")) == raised(
        lambda: J.build_tree(wins, wins, n_coarse=2, leaf_size=2, w=1, p=1))


@pytest.mark.parametrize("p", P_VALUES)
def test_radius_sweeps_change_no_bit_with_the_chunk(p):
    """The sweep's launch split is free: chunks of 7 windows and one chunk
    give the same bits, the plain DP's rooted values."""
    wins, _ = bank()
    wins_t = torch.as_tensor(wins)
    reps = wins_t[[0, 5, 100]]
    one = _rep_dists(reps, wins_t, W, p)
    assert bits_equal(_rep_dists(reps, wins_t, W, p, chunk=7), one)
    acc = dtw_plain(reps, wins_t, W, p)
    want = acc.sqrt() if p == 2 else acc
    assert bits_equal(one, want.numpy())


def test_vacuous_radii_need_no_device(monkeypatch):
    """``radii=False`` runs no sweep: no device is needed, the radii are the
    reference's vacuous ones and the rest of the tree its bits; with radii
    and no device named, no GPU raises."""
    wins, sketch = bank()
    kw = dict(n_coarse=9, leaf_size=8, w=W, p=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = T.build_tree(wins, sketch, radii=False, **kw)
    want = J.build_tree(wins, sketch, radii=False, **kw)
    for f in TREE_INDEX + TREE_BOXES + RADII:
        assert bits_equal(getattr(got, f), getattr(want, f)), f
    assert np.isinf(got.radii_w).all() and (got.min_radii_wide == 0).all()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.build_tree(wins, sketch, **kw)


# -------------------------------------------------------------- build


def test_default_hop_equal():
    assert [default_hop(m) for m in range(1, 300)] == [j_default_hop(m) for m in range(1, 300)]


@pytest.mark.parametrize("p", P_VALUES)
def test_build_anytime_index_matches_reference(p):
    """``build_anytime_index`` alone, the prepared rows given as a tensor:
    the whole-row tier is that tensor, not a copy.  ``w_config=0`` takes
    the paper's m // 10 band below the whole row; explicit ``paa``,
    ``n_coarse`` and ``seed``."""
    prepared = torch.as_tensor(DATA)
    kw = dict(p=p, znorm=False, resolved_w=W, w_config=0, precision="float32",
              lengths=(M, 40, N), paa=6, n_coarse=9, leaf_size=5, seed=4)
    got = T.build_anytime_index(DATA, prepared, **kw)
    same_index(got, J.build_anytime_index(DATA, DATA, **kw))
    assert got.tier(N).wins is prepared
    assert got.tier(M).w == max(M // 10, 1) and got.tier(N).w == W


@pytest.mark.parametrize("kw", [dict(lengths=(1,)), dict(lengths=(N + 1,)),
                                dict(lengths=(M, N), hop=0)],
                         ids=["m1", "m_past_n", "hop0"])
def test_build_anytime_index_validation(kw):
    base = dict(p=1, znorm=False, resolved_w=W, w_config=W, precision="float32")
    got = raised(lambda: T.build_anytime_index(DATA, DATA, device="cpu", **base, **kw))
    assert got == raised(lambda: J.build_anytime_index(DATA, DATA, **base, **kw))
    assert got[0] is ValueError


def test_tier_lookup_and_repr_as_the_reference():
    tdb = Database.build(DATA, SearchConfig(w=W), anytime=True, device="cpu")
    jdb = JDatabase.build(DATA, JConfig(w=W), anytime=True)
    assert raised(lambda: tdb.anytime.tier(M)) == raised(lambda: jdb.anytime.tier(M))
    assert repr(tdb) == repr(jdb)[:-1] + ", device=cpu)"
    assert "anytime=[64]" in repr(tdb)
    same_index(tdb.anytime, jdb.anytime)


def test_arrays_round_trip_and_version_check():
    kw = dict(p=2, znorm=True, resolved_w=W, w_config=W, precision="float32", **OPTS)
    got = T.build_anytime_index(DATA, DATA, device="cpu", **kw)
    want = J.build_anytime_index(DATA, DATA, **kw)
    z, zj = T.anytime_arrays(got), J.anytime_arrays(want)
    assert sorted(z) == sorted(zj)
    for k in z:
        if k.endswith(RADII):
            assert z[k].dtype == zj[k].dtype
            np.testing.assert_allclose(z[k], zj[k], rtol=3e-4)
        else:
            assert bits_equal(z[k], zj[k]), k
    back = T.anytime_from_arrays(z, device="cpu")
    for m in got.lengths:
        for f in TREE_INDEX + TREE_BOXES + RADII:
            assert bits_equal(getattr(back.tier(m).tree, f), getattr(got.tier(m).tree, f))
        assert bits_equal(back.tier(m).wins.numpy(), got.tier(m).wins.numpy())
    same_index(T.anytime_from_arrays(zj, device="cpu"), want)
    same_index(got, J.anytime_from_arrays(z))
    bad = dict(z)
    bad["meta"] = np.array([99.0, 2.0, 0.0])
    assert raised(lambda: T.anytime_from_arrays(bad, device="cpu")) == raised(
        lambda: J.anytime_from_arrays(bad))


# ------------------------------------------------------------ session


@pytest.mark.parametrize("znorm", [False, True])
@pytest.mark.parametrize("p", P_VALUES)
def test_database_build_anytime_matches_reference(p, znorm):
    cfg = dict(w=W, p=p, k=2, znorm=znorm)
    opts = {**OPTS, "seed": 5}
    tdb = Database.build(DATA, SearchConfig(**cfg), anytime=opts, device="cpu")
    jdb = JDatabase.build(DATA, JConfig(**cfg), anytime=dict(opts))
    assert repr(tdb) == repr(jdb)[:-1] + ", device=cpu)"
    same_index(tdb.anytime, jdb.anytime)
    assert tdb.anytime.tier(N).wins is tdb.rows_tensor
    for qlen in (None, N, M):
        assert tdb._anytime_info(qlen) == jdb._anytime_info(qlen)
    # a whole-length exact search answers as the session without the tier
    qs = walks(9, 3, N)
    plain = Database.build(DATA, SearchConfig(**cfg), device="cpu")
    got, want = tdb.search(qs), plain.search(qs)
    assert bits_equal(got.indices, want.indices) and bits_equal(got.distances, want.distances)
    assert got.stats == want.stats
    np.testing.assert_array_equal(got.indices, np.asarray(jdb.search(qs).indices))
    assert tdb._anytime_info() is not None and plain._anytime_info() is None


def test_bundles_load_both_ways(tmp_path):
    cfg = dict(w=W, p=1, znorm=True)
    jdb = JDatabase.build(DATA, JConfig(**cfg), anytime=OPTS)
    tdb = Database.build(DATA, SearchConfig(**cfg), anytime=OPTS, device="cpu")
    # the reference's bundle in the port: its arrays, the whole-row tier
    # on the session's rows tensor
    from_j = Database.load(jdb.save(os.path.join(tmp_path, "ref")), device="cpu")
    same_index(from_j.anytime, jdb.anytime)
    assert from_j.anytime.tier(N).wins is from_j.rows_tensor
    assert repr(from_j) == repr(jdb)[:-1] + ", device=cpu)"
    # the port's bundle in the reference, and in the port: every bit kept
    path = tdb.save(os.path.join(tmp_path, "port"))
    same_index(tdb.anytime, JDatabase.load(path).anytime)
    qs = walks(10, 2, N)
    # through the file, and in memory (what save writes, what load reads)
    for back in (Database.load(path, device="cpu"),
                 Database.from_arrays(tdb.to_arrays(), device="cpu")):
        assert back.anytime.tier(N).wins is back.rows_tensor
        for m in tdb.anytime.lengths:
            a, b = back.anytime.tier(m), tdb.anytime.tier(m)
            assert (a.m, a.hop, a.w) == (b.m, b.hop, b.w)
            assert bits_equal(a.wins.numpy(), b.wins.numpy())
            for f in TREE_INDEX + TREE_BOXES + RADII:
                assert bits_equal(getattr(a.tree, f), getattr(b.tree, f)), f
        assert bits_equal(back.search(qs).distances, tdb.search(qs).distances)
    # a bundle without the tier loads without one
    plain = Database.load(Database.build(DATA, device="cpu").save(
        os.path.join(tmp_path, "plain")), device="cpu")
    assert plain.anytime is None and "anytime=none" in repr(plain)


def test_search_side_raises_item_10b():
    """What still raises once the search side is ported (the name is kept
    so that the test's history stays one): choosing the tier's drivers by
    name, which raises the reference's ``ValueError``; the search side
    itself answers, and so does the engine's anytime mode, with the
    direct search's answer."""
    db = Database.build(DATA, SearchConfig(w=W), anytime=OPTS, device="cpu")
    jdb = JDatabase.build(DATA, JConfig(w=W), anytime=OPTS)
    q = walks(11, 1, N)[0]
    assert isinstance(db.search(q, mode="anytime"), T.AnytimeResult)
    assert isinstance(db.search(q[:M]), T.AnytimeResult)  # a subsequence-length query
    assert db.plan(q, mode="anytime").driver == "anytime"
    for driver in ("subsequence", "anytime"):
        got = raised(lambda: db.plan(q, driver=driver))
        assert got == raised(lambda: jdb.plan(q, driver=driver))
        assert got[0] is ValueError and "not directly selectable" in got[1]
    with QueryEngine(db, max_batch=2, max_wait_ms=0.5) as engine:
        ans = engine.submit(q, mode="anytime").result(timeout=60)
        direct = db.search(q, mode="anytime")
        assert bits_equal(ans.indices, direct.indices)
        assert bits_equal(ans.distances, direct.distances)
        assert bits_equal(ans.error_bounds, direct.error_bounds)
        assert np.array_equal(engine.submit(q).result(timeout=60).indices, db.search(q).indices)
    # without the tier, another length is the reference's ValueError
    with pytest.raises(ValueError, match="query length"):
        Database.build(DATA, device="cpu").search(q[:M])
