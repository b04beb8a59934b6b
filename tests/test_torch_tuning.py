"""repro_torch's kernel tuning tier against the reference's (CPU).

Mirrors the cases of ``tests/test_tuning.py`` that apply to the
univariate port: the config space and its validation, shape buckets,
the resolution order and ``use_table``, schedule parity of the pipeline's
``lane_chunk`` and of the drivers under an eccentric table, the
TuneTable JSON and bundle round trips (and their interchange with
``repro``), ``autotune`` for every family, and the planner's measured
stage costs.  On the CPU the kernel wrappers run their plain versions,
which have no schedule; the CUDA kernels' schedules are held
bit-identical on the card (``tests/test_torch_cuda.py``).

Every test leaves both packages' process-active tune tables as it found
them: a tuned build installs its table process-wide, and later tests in
the same worker compare ``dp_lane_work``, which depends on ``lane_chunk``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.api import Database as JDatabase  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro.api.planner import calibrate as j_calibrate  # noqa: E402
from repro.api.planner import choose_cascade as j_choose  # noqa: E402
from repro.kernels import tuning as jtune  # noqa: E402
from repro.kernels.tuning import table as jtable  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.api.planner import Calibration, calibrate, choose_cascade  # noqa: E402
from repro_torch.core import lb as lb_mod  # noqa: E402
from repro_torch.core.cascade import nn_search_host, nn_search_scan  # noqa: E402
from repro_torch.core.envelope import envelope_batch  # noqa: E402
from repro_torch.core.pipeline import run_block_stages  # noqa: E402
from repro_torch.data.synthetic import random_walks  # noqa: E402
from repro_torch.kernels.envelope.ops import envelope_op  # noqa: E402
from repro_torch.kernels.lb_improved.ops import lb_improved_qbatch_op  # noqa: E402
from repro_torch.kernels.lb_keogh.ops import lb_keogh_qbatch_op  # noqa: E402
from repro_torch.kernels.tuning import (  # noqa: E402
    FALLBACK,
    SESSION_FAMILIES,
    TUNE_FORMAT_VERSION,
    KernelConfig,
    TuneTable,
    autotune,
    resolve_config,
    search_space,
    shape_bucket,
    use_table,
)
from repro_torch.kernels.tuning import table as ttable  # noqa: E402

torch.set_num_threads(1)

RNG = np.random.default_rng(17)
B, N, NQ, W = 13, 33, 3, 3  # ragged: 13 % tile_b != 0 for every tile_b


@pytest.fixture(autouse=True)
def _restore_active_tables():
    j_prev, t_prev = jtable.active_table(), ttable.active_table()
    yield
    jtable.install(j_prev, merge=False)
    ttable.install(t_prev, merge=False)


@pytest.fixture(scope="module")
def problem():
    cands = torch.as_tensor(RNG.normal(size=(B, N)).astype(np.float32).cumsum(axis=1))
    qs = torch.as_tensor(RNG.normal(size=(NQ, N)).astype(np.float32).cumsum(axis=1))
    u, l = envelope_batch(qs, W)
    return cands, qs, u, l


def same(got, want):
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def stats_key(st):
    return (tuple(st.stage_pruned), st.full_dtw, st.dp_lane_work, st.dp_lane_useful)


def entries_of(table):
    return {k: v.to_dict() for k, v in table.entries.items()}


# ----------------------------------------------------------- config space


def test_kernel_config_validation():
    with pytest.raises(ValueError):
        KernelConfig(tile_b=0)
    with pytest.raises(ValueError):
        KernelConfig(depth=3)
    with pytest.raises(ValueError):
        KernelConfig(grid="xy")
    cfg = KernelConfig(tile_b=4, depth=2, grid="bq")
    assert KernelConfig.from_dict(cfg.to_dict()) == cfg
    # the reference's configs read back as the port's and the reverse
    assert KernelConfig.from_dict(jtune.KernelConfig(tile_b=4, depth=2, grid="bq").to_dict()) == cfg
    assert jtune.KernelConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()


def test_search_space_fallback_first():
    for family in SESSION_FAMILIES:
        space = search_space(family)
        assert len(space) == len(set(space))
        assert space[0] == FALLBACK
        # the CUDA kernels run depth 1 only; their knobs keep every
        # reduction order, so only K2/K7, K6, K4 and the pipeline sweep
        assert all(c.depth == 1 for c in space)
    assert {c.tile_b for c in search_space("lb_keogh")} == {4, 8, 16, 32}
    assert {(c.tile_b, c.grid) for c in search_space("lb_fused")} == {
        (t, g) for t in (4, 8, 16, 32) for g in ("qb", "bq")
    }
    for family in ("envelope", "lb_improved", "dtw"):
        assert search_space(family) == (FALLBACK,)
    with pytest.raises(ValueError):
        search_space("nope")


@pytest.mark.parametrize(
    "b,n,d", [(200, 100, None), (256, 128, None), (None, 128, None), (None, None, None),
              (32, 1000, None), (33, 1000, 1), (7, 50, 3), (1, 1, None)]
)
def test_shape_bucket(b, n, d):
    assert shape_bucket(b, n, d) == jtune.shape_bucket(b, n, d)
    assert shape_bucket(200, 100) == "b256n128"
    assert shape_bucket() == "b*n*"


def test_resolution_order():
    t = TuneTable()
    t.set("lb_fused", KernelConfig(tile_b=32), backend="*", bucket="*")
    t.set("lb_fused", KernelConfig(tile_b=16), backend="cuda", bucket="*")
    t.set("lb_fused", KernelConfig(tile_b=4), backend="cuda", bucket="b64n64")
    t.set("lb_fused", KernelConfig(tile_b=2), backend="tpu", bucket="*")
    assert t.resolve("lb_fused", b=60, n=60, backend="cuda").tile_b == 4
    assert t.resolve("lb_fused", b=999, n=60, backend="cuda").tile_b == 16
    assert t.resolve("lb_fused", b=60, n=60, backend="cpu").tile_b == 32
    # nothing matches -> frozen fallback
    assert t.resolve("dtw", b=8, n=8, backend="cuda") == FALLBACK
    with pytest.raises(ValueError):
        t.resolve("nope")
    # untuned, "cuda" resolves the schedule the kernels ran before tuning
    for family, tile_b in (("lb_keogh", 8), ("lb_kim", 8), ("lb_fused", 8)):
        assert ttable.TuneTable.with_defaults().resolve(
            family, b=32, n=1000, backend="cuda").tile_b == tile_b
    assert TuneTable.with_defaults().resolve("pipeline", backend="cpu").lane_chunk == 32


def test_use_table_restores_active():
    before = resolve_config("lb_fused", b=8, n=8, backend="cuda")
    t = TuneTable()
    t.set("lb_fused", KernelConfig(tile_b=16), backend="*")
    with use_table(t):
        assert resolve_config("lb_fused", b=8, n=8, backend="cuda").tile_b == 16
    assert resolve_config("lb_fused", b=8, n=8, backend="cuda") == before


# --------------------------------------------------- schedule parity


def test_lb_keogh_improved_envelope_tile_parity(problem):
    """tile_b is a launch shape only: every value gives the same bits."""
    cands, qs, u, l = problem
    for p in (1, 2, math.inf):
        ref_k = lb_keogh_qbatch_op(cands, u, l, p, tile_b=8)
        ref_i = lb_improved_qbatch_op(cands, qs, u, l, W, p, tile_b=8)
        for tile_b in (4, 16, 32):
            same(lb_keogh_qbatch_op(cands, u, l, p, tile_b=tile_b), ref_k)
            same(lb_improved_qbatch_op(cands, qs, u, l, W, p, tile_b=tile_b), ref_i)
    ref_e = envelope_op(cands, W)
    with use_table(TuneTable(entries={("envelope", "*", "*"): KernelConfig(tile_b=16)})):
        same(envelope_op(cands, W), ref_e)


@pytest.mark.parametrize("p", [1, 2, math.inf])
def test_pipeline_lane_chunk_parity(problem, p):
    cands, qs, u, l = problem
    lbq = lb_mod.lb_keogh_powered_qbatch(cands, u, l, p).numpy()
    bound = torch.as_tensor(np.quantile(lbq, 0.4, axis=1).astype(np.float32))
    mask0 = torch.ones((NQ, B), dtype=torch.bool)
    ref = run_block_stages(qs, u, l, W, p, "lb_improved", cands, bound, mask0, lane_chunk=32)
    for lc in (8, 16, 64):
        st = run_block_stages(qs, u, l, W, p, "lb_improved", cands, bound, mask0,
                              lane_chunk=lc)
        same(st.d, ref.d)
        for m, rm in zip(st.masks, ref.masks):
            same(m, rm)
        assert st.dp_lane_useful == ref.dp_lane_useful
    # lane_chunk=None resolves the "pipeline" family for the block's device
    table = TuneTable(entries={("pipeline", "cpu", "*"): KernelConfig(lane_chunk=8)})
    with use_table(table):
        st = run_block_stages(qs, u, l, W, p, "lb_improved", cands, bound, mask0)
    want = run_block_stages(qs, u, l, W, p, "lb_improved", cands, bound, mask0, lane_chunk=8)
    assert st.dp_lane_work == want.dp_lane_work
    same(st.d, ref.d)


ECCENTRIC = TuneTable(
    entries={
        ("lb_fused", "*", "*"): KernelConfig(tile_b=4, grid="bq"),
        ("pipeline", "*", "*"): KernelConfig(lane_chunk=8),
        ("lb_kim", "*", "*"): KernelConfig(tile_b=16),
        ("lb_keogh", "*", "*"): KernelConfig(tile_b=4),
    }
)


@pytest.mark.parametrize("p", [1, 2, math.inf])
def test_driver_topk_parity_across_schedules(p):
    """Top-k values, indices and stage counters do not depend on the
    schedule, except the chunk-padded dp_lane_work of the scan driver."""
    data = random_walks(np.random.default_rng(5), 48, 40)
    qs = data[:3] + RNG.normal(scale=0.3, size=(3, 40)).astype(np.float32)
    want_scan = nn_search_scan(qs, data, w=4, p=p, k=3, block=16, device="cpu")
    want_host = nn_search_host(qs, data, w=4, p=p, k=3, block=16, device="cpu")
    with use_table(ECCENTRIC):
        got_scan = nn_search_scan(qs, data, w=4, p=p, k=3, block=16, device="cpu")
        got_host = nn_search_host(qs, data, w=4, p=p, k=3, block=16, device="cpu")
    for got, want in ((got_scan, want_scan), (got_host, want_host)):
        np.testing.assert_array_equal(got.distances, want.distances)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert got.stats.stage_pruned == want.stats.stage_pruned
        assert got.stats.full_dtw == want.stats.full_dtw
        assert got.stats.dp_lane_useful == want.stats.dp_lane_useful
    assert got_host.stats == want_host.stats


# ----------------------------------------------------------- persistence


def test_tunetable_json_roundtrip():
    t = TuneTable()
    t.set("lb_fused", KernelConfig(tile_b=16, grid="bq"), backend="cuda", bucket="b64n128")
    t.set("pipeline", KernelConfig(lane_chunk=64), backend="*")
    t.stage_costs = {"lb_keogh": 2.5, "full": 11.0}
    back = TuneTable.from_json(t.to_json())
    assert back.entries == t.entries
    assert back.stage_costs == t.stage_costs
    arrs = t.to_arrays()
    assert int(arrs["version"]) == TUNE_FORMAT_VERSION == jtune.TUNE_FORMAT_VERSION
    assert TuneTable.from_arrays(arrs).entries == t.entries


def test_tunetable_json_interchange_with_reference():
    """The same entries written by either package read back equal in the
    other; entries of the reference's backends are kept, never resolved."""
    j = jtune.TuneTable()
    j.set("lb_fused", jtune.KernelConfig(tile_b=16, depth=2, grid="bq"), backend="tpu",
          bucket="b64n128")
    j.set("pipeline", jtune.KernelConfig(lane_chunk=64), backend="cpu")
    j.stage_costs = {"lb_kim": 0.5, "full": 21.0}
    t = TuneTable.from_json(j.to_json())
    assert entries_of(t) == entries_of(j) and t.stage_costs == j.stage_costs
    assert t.to_json() == j.to_json()
    assert t.resolve("lb_fused", b=64, n=128, backend="cuda") == FALLBACK
    back = jtune.TuneTable.from_json(t.to_json())
    assert entries_of(back) == entries_of(j) and back.stage_costs == j.stage_costs


def test_tunetable_rejects_unknown_version():
    bad = TuneTable().to_json().replace(
        f'"version": {TUNE_FORMAT_VERSION}', '"version": 99'
    )
    with pytest.raises(ValueError, match="unsupported"):
        TuneTable.from_json(bad)


def test_tuned_bundle_roundtrip(tmp_path):
    """build(tune=...) sweeps on the session's device, keeps the table,
    saves it as tune_* keys, and load re-installs it."""
    data = random_walks(np.random.default_rng(8), 32, 24)
    db = Database.build(
        data, SearchConfig(w=2, p=1, k=2),
        tune=dict(families=("pipeline", "lb_fused"), iters=1, b=16, nq=2,
                  measure_costs=False),
        device="cpu",
    )
    assert db.tune_table is not None
    assert {k[1] for k in db.tune_table.entries} == {"cpu"}
    path = db.save(str(tmp_path / "tuned"))
    with np.load(path) as z:
        assert "tune_json" in z.files and "tune_version" in z.files
    ttable.install(TuneTable(), merge=False)
    db2 = Database.load(path, device="cpu")
    assert db2.tune_table.to_json() == db.tune_table.to_json()
    assert ttable.active_table().entries[("pipeline", "cpu", "*")] == (
        db.tune_table.entries[("pipeline", "cpu", "*")]
    )
    r1, r2 = db.search(data[:2]), db2.search(data[:2])
    np.testing.assert_array_equal(r1.distances, r2.distances)
    np.testing.assert_array_equal(r1.indices, r2.indices)


def test_legacy_bundle_without_tune_keys(tmp_path):
    data = random_walks(np.random.default_rng(9), 24, 20)
    db = Database.build(data, SearchConfig(w=2, p=2, k=1), device="cpu")
    path = db.save(str(tmp_path / "legacy"))
    with np.load(path) as z:
        assert not any(k.startswith("tune_") for k in z.files)
    db2 = Database.load(path, device="cpu")
    assert db2.tune_table is None
    r1, r2 = db.search(data[:2]), db2.search(data[:2])
    np.testing.assert_array_equal(r1.distances, r2.distances)
    np.testing.assert_array_equal(r1.indices, r2.indices)


def test_tuned_bundles_cross_load(tmp_path):
    """A tuned bundle of repro loads into repro_torch and answers the same,
    and the port's tuned bundle loads into repro."""
    x = random_walks(np.random.default_rng(10), 40, 24)
    q = x[:3] + RNG.normal(scale=0.3, size=(3, 24)).astype(np.float32)
    tune = dict(iters=1, families=("lb_kim", "pipeline"))
    jdb = JDatabase.build(x, JConfig(k=2, method="auto"), tune=tune)
    path = jdb.save(str(tmp_path / "ref"))
    tdb = Database.load(path, device="cpu")
    assert tdb.tune_table.to_json() == jdb.tune_table.to_json()
    jr, tr = jdb.search(q), tdb.search(q)
    np.testing.assert_array_equal(tr.indices, np.asarray(jr.indices))
    np.testing.assert_allclose(tr.distances, np.asarray(jr.distances), rtol=2e-4)
    # the scan driver's chunk-padded DP work follows the loaded lane_chunk
    assert stats_key(tr.stats) == stats_key(jr.stats)
    assert tdb.plan(q).cascade.cost_source == jdb.plan(q).cascade.cost_source

    pdb = Database.build(x, SearchConfig(k=2, method="auto"), tune=tune, device="cpu")
    ppath = pdb.save(str(tmp_path / "port"))
    back = JDatabase.load(ppath)
    assert back.tune_table.to_json() == pdb.tune_table.to_json()
    br, pr = back.search(q), pdb.search(q)
    np.testing.assert_array_equal(pr.indices, np.asarray(br.indices))
    np.testing.assert_allclose(pr.distances, np.asarray(br.distances), rtol=2e-4)


# -------------------------------------------------------------- autotune


@pytest.mark.parametrize("family", SESSION_FAMILIES)
def test_autotune_sweep_is_bit_identical_and_in_space(family):
    res = autotune(family, b=8, n=16, w=2, p=1, nq=2, iters=1, device="cpu")
    assert res.best in search_space(family)
    assert all(e.identical and e.runnable for e in res.entries)
    assert [e.config for e in res.entries] == list(search_space(family))
    assert res.bucket == shape_bucket(8, 16)
    assert f"autotune {family}" in res.explain()


# ------------------------------------------------------ planner override


def test_choose_cascade_measured_costs_override():
    data = random_walks(np.random.default_rng(11), 40, 32)
    cal = calibrate(torch.as_tensor(data), 3, 1, sample_q=2, sample_c=16)
    analytic = choose_cascade(cal, k=1)
    assert set(analytic.cost_source) == {"analytic"}
    assert "analytic (no tune sweep measured)" in analytic.explain()
    measured = choose_cascade(cal, k=1, unit_costs={"lb_keogh": 0.5, "full": 7.0})
    srcs = dict(zip(measured.stages, measured.cost_source))
    costs = dict(zip(measured.stages, measured.stage_cost))
    assert srcs["full"] == "measured" and costs["full"] == 7.0
    if "lb_keogh" in srcs:
        assert srcs["lb_keogh"] == "measured" and costs["lb_keogh"] == 0.5
    assert "measured by the kernel tune sweep" in measured.explain()


@pytest.mark.parametrize("unit_costs", [
    None,
    {"lb_keogh": 0.5, "full": 7.0},
    {"lb_kim": 0.01, "lb_keogh": 4.0, "lb_improved": 9.0, "lb_webb": 3.0, "full": 40.0},
])
def test_choose_cascade_matches_reference(unit_costs):
    """The reference's calibration through both planners: the same
    stages, costs and cost sources."""
    data = random_walks(np.random.default_rng(12), 40, 32)
    jcal = j_calibrate(data, 3, 1, sample_q=2, sample_c=16)
    tcal = Calibration.from_arrays(jcal.to_arrays())
    want = j_choose(jcal, k=2, unit_costs=unit_costs)
    got = choose_cascade(tcal, k=2, unit_costs=unit_costs)
    assert (got.method, got.stages, got.cost_source) == (
        want.method, want.stages, want.cost_source)
    np.testing.assert_allclose(got.stage_cost, want.stage_cost, rtol=1e-12)
    assert [m for m, _ in got.predicted] == [m for m, _ in want.predicted]
    assert got.explain() == want.explain()
