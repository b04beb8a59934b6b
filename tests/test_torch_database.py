"""repro_torch's session API against repro.api (CPU).

The facade (build, plan, search, topk, classify, save/load), the
``repro`` -> ``repro_torch`` bundle cross-load, one float64 session (the
JAX side in a subprocess with x64 enabled only there), the import guard
(no JAX and no ``repro`` module loaded by the port) and the refusal to
run quietly on the CPU when no device is named and no GPU exists.
"""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from helpers import SRC, run_in_subprocess  # noqa: E402
from repro.api import Database as JDatabase  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.api.planner import SMALL_DB_ROWS, choose_cascade  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.stream import StreamMatcher  # noqa: E402

torch.set_num_threads(1)


def walks(seed, rows, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


def same_answers(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.indices), tres.indices)
    np.testing.assert_allclose(tres.distances, np.asarray(jres.distances), rtol=2e-4)
    assert tuple(jres.stats.stage_pruned) == tuple(tres.stats.stage_pruned)
    assert jres.stats.full_dtw == tres.stats.full_dtw


CONFIGS = [
    dict(),
    dict(k=5, p=2),
    dict(k=3, p="inf", method="lb_webb"),
    dict(k=2, znorm=True, method="kim_improved"),
    dict(k=4, method="auto"),
    dict(k=2, method="full", w=7),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: json.dumps(c, sort_keys=True))
def test_facade_matches_repro(cfg):
    x, q = walks(1, 150, 48), walks(2, 6, 48)
    jdb = JDatabase.build(x, JConfig(**cfg))
    tdb = Database.build(x, SearchConfig(**cfg), device="cpu")
    assert tdb.w == jdb.w
    np.testing.assert_array_equal(tdb.upper, jdb.upper)
    np.testing.assert_array_equal(tdb.lower, jdb.lower)
    np.testing.assert_array_equal(tdb.row_sums, jdb.row_sums)
    np.testing.assert_allclose(tdb.calibration.dtw, jdb.calibration.dtw, rtol=3e-4)
    np.testing.assert_allclose(tdb.calibration.bounds, jdb.calibration.bounds,
                               rtol=2e-4, atol=1e-4)
    jp, tp = jdb.plan(q), tdb.plan(q)
    assert (tp.driver, tp.stages) == (jp.driver, jp.stages)
    assert tp.config.method == jp.config.method
    same_answers(jdb.search(q), tdb.search(q))
    same_answers(jdb.search(q[0]), tdb.search(q[0]))
    same_answers(jdb.topk(q, 1), tdb.topk(q, 1))


def test_host_route_classify_and_config_parity():
    x, q = walks(3, SMALL_DB_ROWS + 40, 32), walks(4, 5, 32)
    cfg = dict(k=3)
    jdb = JDatabase.build(x, JConfig(**cfg))
    tdb = Database.build(x, SearchConfig(**cfg), device="cpu")
    assert tdb.plan(q).driver == jdb.plan(q).driver == "host"
    assert tdb.plan(q).explain().startswith("driver: host")
    same_answers(jdb.search(q), tdb.search(q))
    same_answers(jdb.search(q, driver="scan"), tdb.search(q, driver="scan"))
    labels = np.arange(len(x)) % 4
    np.testing.assert_array_equal(tdb.classify(labels, q), jdb.classify(labels, q))
    assert tdb.classify(labels, q[0]) == jdb.classify(labels, q[0])
    assert SearchConfig(**cfg).stable_hash() == JConfig(**cfg).stable_hash()
    assert tdb.fingerprint == jdb.fingerprint
    for a, b in zip(tdb.row_mean_std(), jdb.row_mean_std()):
        np.testing.assert_array_equal(a, b)
    tc = choose_cascade(tdb.calibration, k=3)
    assert tc.method == jdb._resolve_method(JConfig(method="auto", k=3))[1].method


def test_bundle_cross_load_and_round_trip(tmp_path):
    """A bundle written by repro loads into repro_torch (the port's
    'weights') and answers the same; the port's own bundle round-trips."""
    x, q = walks(5, 120, 40), walks(6, 4, 40)
    jdb = JDatabase.build(x, JConfig(k=3, p=2, znorm=True))
    path = jdb.save(str(tmp_path / "ref"))
    tdb = Database.load(path, device="cpu")
    assert tdb.config.to_json() == jdb.config.to_json()
    np.testing.assert_array_equal(tdb.upper, jdb.upper)
    same_answers(jdb.search(q), tdb.search(q))
    back = Database.load(tdb.save(str(tmp_path / "port")), device="cpu")
    same_answers(jdb.search(q), back.search(q))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    same_answers(jdb.search(q), Database.from_arrays(arrays, device="cpu").search(q))
    # the reference loads the port's bundle too
    same_answers(tdb.search(q), JDatabase.load(str(tmp_path / "port.npz")).search(q))


def test_bundles_of_unported_tiers_raise(tmp_path):
    x = walks(7, 60, 24)
    # the anytime tier's build side is ported: it builds and shows in repr
    assert "anytime=[24]" in repr(Database.build(x, anytime=True, device="cpu"))
    # the multivariate tier builds, searches and streams
    mv = Database.build(np.stack([x, x], axis=-1), device="cpu")
    assert mv.channels == 2 and mv.search(np.stack([x[0], x[0]], axis=-1)).index == 0
    assert SearchConfig(method="tc_box").method == "tc_box"
    mv_stream = mv.stream(threshold=1.0)
    assert isinstance(mv_stream, StreamMatcher) and mv_stream.d == 2
    assert len(mv_stream.states) == 2 and mv_stream.scanner._upper is mv._upper
    db = Database.build(x, device="cpu")
    # the sharded driver is ported: use_mesh attaches a mesh (one gloo rank)
    mesh = make_host_mesh(device="cpu")
    try:
        sharded = Database.build(x, device="cpu").use_mesh(mesh)
        assert "mesh=attached" in repr(sharded) and "mesh=none" in repr(db)
        assert sharded.plan(x[:2]).driver == "sharded"
        np.testing.assert_array_equal(sharded.search(x[:2]).indices, db.search(x[:2]).indices)
    finally:
        dist.destroy_process_group()
    # (Q, n, 2) templates on a univariate session end as the reference's
    # call ends: a ValueError, not a missing port
    mv_tpl = np.stack([x[:2], x[:2]], axis=-1)
    with pytest.raises(ValueError):
        JDatabase.build(x).stream(mv_tpl, threshold=1.0)
    with pytest.raises(ValueError):
        db.stream(mv_tpl, threshold=1.0)
    assert isinstance(db.stream(threshold=1.0), StreamMatcher)
    # the anytime tier's search side is ported too: it answers as the exact route
    tier = Database.build(x, anytime=True, device="cpu")
    got, want = tier.search(x[:2], mode="anytime"), db.search(x[:2])
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.distances, want.distances)
    assert (got.error_bounds == 0).all()
    # a reference bundle with the tier loads, its any_* arrays with it
    jdb = JDatabase.build(x, JConfig(), anytime=True)
    back = Database.load(jdb.save(str(tmp_path / "anytime")), device="cpu")
    assert back.anytime.lengths == (24,) and back.anytime.tier(24).wins is back.rows_tensor
    np.testing.assert_array_equal(back.anytime.tier(24).tree.members,
                                  jdb.anytime.tier(24).tree.members)
    got = back.search(x[:2], mode="anytime")
    np.testing.assert_array_equal(got.indices, db.search(x[:2]).indices)
    np.testing.assert_array_equal(got.distances, db.search(x[:2]).distances)


def test_indexed_session_matches_repro(tmp_path):
    """Database.build(index=True) in both packages: the same references,
    the indexed plan, the same answers and counters; each package's
    indexed bundle loads in the other and answers the same."""
    x, q = walks(15, 150, 40), walks(16, 4, 40)
    cfg = dict(k=2, p="inf")
    jdb = JDatabase.build(x, JConfig(**cfg), index=True, n_refs=6, n_clusters=4, seed=3)
    tdb = Database.build(x, SearchConfig(**cfg), index=True, n_refs=6, n_clusters=4,
                         seed=3, device="cpu")
    np.testing.assert_array_equal(tdb.index.ref_idx, jdb.index.ref_idx)
    np.testing.assert_array_equal(tdb.index.clustering.assign, jdb.index.clustering.assign)
    assert "index=R=6" in repr(tdb)
    jp, tp = jdb.plan(q), tdb.plan(q)
    assert (tp.driver, tp.stages) == (jp.driver, jp.stages) == (
        "indexed", ("lb_tri", "lb_keogh", "lb_improved", "full"))
    explain = tp.explain()
    assert explain.startswith("driver: indexed (repro_torch.core.cascade.nn_search_indexed)")
    assert "stages: lb_tri -> lb_keogh" in explain and jp.reasons == tp.reasons
    jres = jdb.search(q)
    same_answers(jres, tdb.search(q))
    assert tdb.search(q).stats.lb0_pruned == jres.stats.lb0_pruned > 0
    same_answers(jdb.search(q[0]), tdb.search(q[0]))
    # a caller override of the driver still answers the same
    same_answers(jdb.search(q, driver="host"), tdb.search(q, driver="host"))
    # bundles with idx_* keys pass both ways
    from_ref = Database.load(jdb.save(str(tmp_path / "ref")), device="cpu")
    assert from_ref.plan(q).driver == "indexed"
    same_answers(jres, from_ref.search(q))
    from_port = JDatabase.load(tdb.save(str(tmp_path / "port")))
    np.testing.assert_array_equal(from_port.index.ref_idx, tdb.index.ref_idx)
    same_answers(from_port.search(q), tdb.search(q))
    # a prebuilt index attaches after validation; a foreign one is refused
    same_answers(jres, Database.build(x, SearchConfig(**cfg), index=from_ref.index,
                                      device="cpu").search(q))
    with pytest.raises(ValueError, match="different database"):
        Database.build(x + 1.0, SearchConfig(**cfg), index=from_ref.index, device="cpu")
    with pytest.raises(TypeError, match="index must be"):
        Database.build(x, index="yes", device="cpu")
    # the indexed driver on a session without an index: the reference's error
    plain = Database.build(x, SearchConfig(**cfg), device="cpu")
    with pytest.raises(ValueError) as te:
        plain.search(q, driver="indexed")
    with pytest.raises(ValueError) as je:
        JDatabase.build(x, JConfig(**cfg)).search(q, driver="indexed")
    assert str(te.value) == str(je.value)


STATS_PROPERTIES = ("lb1_pruned", "lb2_pruned", "pruning_ratio", "stage0_ratio",
                    "dp_lane_efficiency", "lb0_pruned", "ref_dtw", "clusters_total",
                    "clusters_pruned")


@pytest.mark.parametrize("route", ["scan", "host", "indexed"])
def test_search_stats_properties_match_repro(route):
    """SearchStats carries the reference's stage-0 fields and properties,
    per query and aggregated, on every ported route."""
    rows = SMALL_DB_ROWS + 40 if route == "host" else 120
    x, q = walks(17, rows, 32), walks(18, 3, 32)
    index = route == "indexed"
    jdb = JDatabase.build(x, JConfig(k=2), index=index, n_refs=5)
    tdb = Database.build(x, SearchConfig(k=2), index=index, n_refs=5, device="cpu")
    assert tdb.plan(q).driver == jdb.plan(q).driver == route
    jres, tres = jdb.search(q), tdb.search(q)
    same_answers(jres, tres)
    for a, b in zip((jres.stats, *jres.per_query), (tres.stats, *tres.per_query)):
        assert {f: getattr(b, f) for f in STATS_PROPERTIES} == {
            f: getattr(a, f) for f in STATS_PROPERTIES}


def test_validation_messages_match_reference():
    x = walks(8, 40, 16)
    db = Database.build(x, device="cpu")
    for bad in (dict(w=-1), dict(k=0), dict(block=0), dict(p=3),
                dict(precision="float16")):
        with pytest.raises(ValueError) as te:
            SearchConfig(**bad)
        with pytest.raises(ValueError) as je:
            JConfig(**bad)
        # the same messages, pointing at the port's own modules
        assert str(te.value) == str(je.value).replace("repro.", "repro_torch.")
    # unknown methods list the six univariate pipelines ported so far
    with pytest.raises(ValueError, match="method='nope' unknown"):
        SearchConfig(method="nope")
    with pytest.raises(ValueError, match="query length"):
        db.search(walks(9, 2, 17))
    with pytest.raises(ValueError, match="k=41"):
        db.search(x[:1], k=41)
    with pytest.raises(ValueError, match="labels"):
        db.classify(np.zeros(3), x[:1])


def test_build_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Database.build(walks(10, 20, 16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Database.from_arrays({"bundle_format_version": np.int64(1)})


def test_float64_session_matches_repro_x64():
    """precision='float64': the JAX side runs with x64 in a subprocess
    (never in this process); values agree to 1e-12.  The host driver is
    used because the reference's scan driver fails under x64 (its int32
    top-k index carry becomes int64; ROADMAP.md queue 3)."""
    x, q = walks(11, 90, 32).astype(np.float64), walks(12, 3, 32).astype(np.float64)
    code = f"""
import json, numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro.api import Database, SearchConfig
x = np.asarray({x.tolist()!r}); q = np.asarray({q.tolist()!r})
r = Database.build(x, SearchConfig(k=3, p=2, precision="float64")).search(q, driver="host")
print(json.dumps({{"i": np.asarray(r.indices).tolist(),
                  "d": np.asarray(r.distances).tolist()}}))
"""
    out = json.loads(run_in_subprocess(code, n_devices=1).strip().splitlines()[-1])
    res = Database.build(
        x, SearchConfig(k=3, p=2, precision="float64"), device="cpu"
    ).search(q, driver="host")
    assert res.distances.dtype == np.float64
    np.testing.assert_array_equal(res.indices, np.asarray(out["i"]))
    np.testing.assert_allclose(res.distances, np.asarray(out["d"]), rtol=1e-12)


def test_port_imports_no_jax_and_no_repro():
    """Every repro_torch module imports in a fresh process without pulling
    in jax or the reference package."""
    code = """
import importlib, pkgutil, sys, json
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({"modules": len(names), "bad": bad}))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 20
    assert out["bad"] == []


def test_p_inf_and_method_override():
    x, q = walks(13, 100, 30), walks(14, 3, 30)
    jdb = JDatabase.build(x, JConfig(k=2, p=math.inf))
    tdb = Database.build(x, SearchConfig(k=2, p=math.inf), device="cpu")
    for method in ("lb_keogh", "kim_webb"):
        same_answers(jdb.search(q, method=method), tdb.search(q, method=method))
