"""The host driver's device-resident block loop, on the CPU.

``repro_torch.core.cascade.fused_block_loop`` serves ``nn_search_host``
for the fused LB_Keogh -> LB_Improved pipeline (``lb_improved``) and for
LB_Kim then that pair (``kim_improved``, K4's kim entry) at p in {1, 2}:
per block K4 writes each pair's stage, and K5's masked-dense entry runs
the survivors and, in the same launch, merges them into the top-k and the
counters (``dtw_masked_prepare(..., merge=...)``).  On the CPU each step
is its kernel's plain version, so these tests hold the loop,
``lb_kim_plain``, ``lb_fused_stage_plain``, ``dtw_masked_plain`` and
``block_merge_plain`` (alone and as the merged entry's CPU route) against
``repro.core.cascade.nn_search_host`` and its numpy merge: equal top-k
indices, distances within rtol 2e-4 (float32 DP against the
reference's), equal ``SearchStats`` field by field, and ties won by the
lower row.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import cascade as jcas  # noqa: E402
from repro.core import lb as jlb  # noqa: E402
from repro_torch.core import cascade as tcas  # noqa: E402
from repro_torch.kernels.block_merge import block_merge_plain  # noqa: E402
from repro_torch.kernels.dtw import (  # noqa: E402
    dtw_masked_plain,
    dtw_masked_prepare,
    dtw_pairs_op,
    dtw_wavefront_plain,
)
from repro_torch.kernels.envelope.ops import envelope_plain  # noqa: E402
from repro_torch.kernels.lb_fused import (  # noqa: E402
    PAD_STAGE,
    lb_fused_plain,
    lb_fused_stage_plain,
)
from repro_torch.kernels.lb_kim import lb_kim_features_plain, lb_kim_plain  # noqa: E402

torch.set_num_threads(1)

N_DB, N, W, BLOCK, CHUNK = 230, 48, 5, 32, 4  # 230 = 7 x 32 + 6: a ragged tail


def walks(rng, rows, n=N):
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


def stats_key(s):
    return (s.n_candidates, s.full_dtw, s.stage_names, tuple(s.stage_pruned),
            s.blocks_total, s.blocks_lb2, s.blocks_dtw, s.dp_lane_work,
            s.dp_lane_useful)


def assert_same(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.indices), tres.indices)
    np.testing.assert_allclose(tres.distances, np.asarray(jres.distances), rtol=2e-4)
    assert stats_key(tres.stats) == stats_key(jres.stats)
    jq, tq = getattr(jres, "per_query", ()), getattr(tres, "per_query", ())
    assert len(jq) == len(tq)
    for js, ts in zip(jq, tq):
        assert stats_key(ts) == stats_key(js)


@pytest.fixture
def loop_calls(monkeypatch):
    """The ``kim`` argument of each run of the device-resident loop inside
    nn_search_host."""
    calls = []
    loop = tcas.fused_block_loop

    def counting(*args, kim, **kwargs):
        calls.append(kim)
        return loop(*args, kim=kim, **kwargs)

    monkeypatch.setattr(tcas, "fused_block_loop", counting)
    return calls


@pytest.mark.parametrize("method", ["lb_improved", "kim_improved"])
@pytest.mark.parametrize("early_abandon", [False, True])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("nq", [1, 8])
def test_device_loop_matches_reference(nq, k, p, early_abandon, method, loop_calls):
    rng = np.random.default_rng(100 + nq + k)
    db, qs = walks(rng, N_DB), walks(rng, nq)
    q = qs if nq > 1 else qs[0]
    jres = jcas.nn_search_host(q, db, W, p, k, BLOCK, CHUNK, method,
                               early_abandon=early_abandon)
    tres = tcas.nn_search_host(q, db, W, p, k, BLOCK, CHUNK, method,
                               early_abandon=early_abandon, device="cpu")
    assert loop_calls == [method == "kim_improved"]
    assert isinstance(tres, tcas.SearchResult if nq == 1 else tcas.BatchSearchResult)
    assert_same(jres, tres)
    assert tres.stats.blocks_dtw > tres.stats.blocks_total // 2  # several chunks pooled


@pytest.mark.parametrize("method", ["lb_improved", "kim_improved"])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("k", [1, 5])
def test_device_loop_ties_go_to_the_lower_row(k, p, method, loop_calls):
    """Each row appears three times, in three blocks and within blocks,
    and the queries are database rows: equal distances everywhere, the
    top-k must list the lower rows first, as the reference's stable
    argsort does."""
    rng = np.random.default_rng(7)
    base = walks(rng, 40)
    db = np.concatenate([base, base[::-1], base[rng.permutation(40)]])
    qs = np.stack([base[3], base[17], base[30] + 0.01])
    jres = jcas.nn_search_host(qs, db, W, p, k, 16, CHUNK, method)
    tres = tcas.nn_search_host(qs, db, W, p, k, 16, CHUNK, method, device="cpu")
    assert loop_calls == [method == "kim_improved"]
    assert_same(jres, tres)
    assert tres.indices[0, 0] == 3 and tres.indices[1, 0] == 17
    for qi in range(len(qs)):  # equal values in the top-k: rows ascending
        d, i = tres.distances[qi], tres.indices[qi]
        for j in range(k - 1):
            assert d[j] < d[j + 1] or i[j] < i[j + 1]


@pytest.mark.parametrize("early_abandon", [False, True])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("nq", [1, 8])
def test_merged_entry_cpu_route_is_the_two_plain_versions(nq, k, p, early_abandon):
    """The CPU route of K5's masked entry with the merge, block after
    block with the bound read from the top-k it merges into, equals
    ``dtw_masked_plain`` then ``block_merge_plain`` bit for bit (DP slots,
    top-k, counts, totals); over the whole database it answers as
    ``repro.core.cascade.nn_search_host``.  Rows repeat within and across
    blocks and the queries are database rows, so distances tie."""
    rng = np.random.default_rng(30 + nq + k)
    base = walks(rng, 30)
    db = np.concatenate([base, base[::-1], base[rng.permutation(30)], base[:12]])
    qs = db[rng.integers(0, len(db), nq)] + (rng.random((nq, N)) < 0.1) * 0.5
    qs = qs.astype(np.float32)
    q_t, db_t = torch.as_tensor(qs), torch.as_tensor(db)
    upper, lower = envelope_plain(q_t, W)
    block = 16
    state = [torch.full((nq, k), 1e30), torch.full((nq, k), -1, dtype=torch.int64),
             torch.zeros((3, nq), dtype=torch.int64), torch.zeros(4, dtype=torch.int64)]
    want = [x.clone() for x in state]
    stage = torch.empty((nq, block), dtype=torch.uint8)
    out, out_want = torch.full((nq, block), math.nan), torch.full((nq, block), math.nan)
    bound = state[0][:, -1]
    run = dtw_masked_prepare(q_t, W, p, stage, bound if early_abandon else None, out,
                             merge=(*state, CHUNK))
    for lo in range(0, len(db), block):
        real = min(block, len(db) - lo)
        cands = db_t[lo : lo + block]
        if real < block:
            cands = torch.cat([cands, cands[-1:].expand(block - real, N)])
        lb1, lb = lb_fused_plain(cands, q_t, upper, lower, W, bound, p)
        stage.copy_(lb_fused_stage_plain(lb1, lb, bound, real))
        wb = want[0][:, -1].clone() if early_abandon else None
        dtw_masked_plain(q_t, cands, stage, W, p, wb, out_want)
        block_merge_plain(*want, stage, out_want, lo, CHUNK)
        assert run(cands, lo) is out
        live = stage == 2
        assert torch.equal(out[live], out_want[live])
        for got, exp in zip(state, want):
            assert torch.equal(got, exp)
    jres = jcas.nn_search_host(qs if nq > 1 else qs[0], db, W, p, k, block, CHUNK,
                               "lb_improved", early_abandon=early_abandon)
    np.testing.assert_array_equal(np.asarray(jres.indices).reshape(nq, k), state[1].numpy())
    got_d = tcas.finish_cost(state[0], p).numpy()
    np.testing.assert_allclose(got_d, np.asarray(jres.distances).reshape(nq, k), rtol=2e-4)
    s = jres.stats
    assert state[2].sum(dim=1).tolist() == [*s.stage_pruned, s.full_dtw]
    assert state[3].tolist() == [s.blocks_lb2, s.blocks_dtw, s.dp_lane_work,
                                 s.dp_lane_useful]


@pytest.mark.parametrize("method,p,fused", [
    ("lb_improved", 1, True), ("lb_improved", 2, True), ("lb_improved", math.inf, False),
    ("kim_improved", 1, True), ("kim_improved", 2, True), ("kim_improved", math.inf, False),
    ("kim_webb", 1, False), ("lb_keogh", 1, False),
])
def test_device_loop_serves_only_the_fused_pipeline(method, p, fused, loop_calls):
    rng = np.random.default_rng(8)
    db, qs = walks(rng, 100), walks(rng, 3)
    jres = jcas.nn_search_host(qs, db, W, p, 2, BLOCK, CHUNK, method)
    tres = tcas.nn_search_host(qs, db, W, p, 2, BLOCK, CHUNK, method, device="cpu")
    assert loop_calls == ([method == "kim_improved"] if fused else [])
    assert_same(jres, tres)


@pytest.mark.parametrize("real", [BLOCK, BLOCK - 5])
@pytest.mark.parametrize("p", [1, 2])
def test_stage_plain_matches_the_host_masks(p, real):
    """The stage K4 derives against float32 bounds sorts the pairs as the
    host loop's float64 masks did: dead (lb1 >= bound), pruned by pass 2
    (lb >= bound), survivor; pad rows 255."""
    rng = np.random.default_rng(9 + p)
    cands, qs = torch.as_tensor(walks(rng, BLOCK)), torch.as_tensor(walks(rng, 6))
    upper, lower = envelope_plain(qs, W)
    lb1_all, _ = lb_fused_plain(cands, qs, upper, lower, W, torch.full((6,), math.inf), p)
    # host bounds: float32 values held in float64 (DP outputs), BIG, and 0
    bound64 = np.quantile(lb1_all.numpy(), 0.4, axis=1).astype(np.float32).astype(np.float64)
    bound64[1], bound64[2] = 1e30, 0.0
    bound32 = torch.as_tensor(bound64, dtype=torch.float32)
    lb1, lb = lb_fused_plain(cands, qs, upper, lower, W, bound32, p)
    stage = lb_fused_stage_plain(lb1, lb, bound32, real).numpy()
    alive1 = lb1.numpy() < bound64[:, None]
    alive2 = alive1 & (lb.numpy() < bound64[:, None])
    assert stage.dtype == np.uint8
    np.testing.assert_array_equal(stage[:, real:], PAD_STAGE)
    np.testing.assert_array_equal(stage[:, :real] == 0, ~alive1[:, :real])
    np.testing.assert_array_equal(stage[:, :real] == 1, (alive1 & ~alive2)[:, :real])
    np.testing.assert_array_equal(stage[:, :real] == 2, alive2[:, :real])
    assert {0, 1, 2} <= set(np.unique(stage[:, :real]).tolist())


def reference_merge_blocks(top_v, top_i, blocks, k, chunk, n_lb=2):
    """repro.core.cascade.nn_search_host's survivor pooling and numpy
    merge (its closure ``merge``), with its counters, over blocks of
    (lo, stage, dvals): stage s < n_lb pruned by LB stage s, n_lb a
    survivor, 255 a pad row."""
    nq = top_v.shape[0]
    top_v, top_i = top_v.astype(np.float64), top_i.copy()
    pruned = np.zeros((n_lb, nq), np.int64)
    c3 = np.zeros(nq, np.int64)
    b2 = b3 = work = useful = 0

    def merge(qi, vals, idxs):
        av = np.concatenate([top_v[qi], vals])
        ai = np.concatenate([top_i[qi], idxs])
        order = np.argsort(av, kind="stable")[:k]
        top_v[qi], top_i[qi] = av[order], ai[order]

    for lo, stage, dvals in blocks:
        for j in range(n_lb):
            pruned[j] += (stage == j).sum(axis=1)
        alive = stage == n_lb
        b2 += int(((stage >= 1) & (stage <= n_lb)).any())
        pair_q, pair_c = np.nonzero(alive)
        c3 += alive.sum(axis=1)
        for s0 in range(0, len(pair_q), chunk):
            sel_q, sel_c = pair_q[s0 : s0 + chunk], pair_c[s0 : s0 + chunk]
            b3 += 1
            work += chunk
            useful += len(sel_q)
            for qi in np.unique(sel_q):
                sel = sel_q == qi
                merge(int(qi), dvals[qi, sel_c[sel]].astype(np.float64), lo + sel_c[sel])
    return top_v, top_i, np.concatenate([pruned, c3[None]]), np.array([b2, b3, work, useful])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("nq", [1, 8])
def test_plain_merge_equals_the_reference_numpy_merge(nq, k, dtype):
    """Values drawn from a few levels, so survivors tie with each other
    and with entries already in the top-k; dead slots hold NaN."""
    rng = np.random.default_rng(11 + nq + k)
    nb, chunk = 24, 5
    top_v = torch.full((nq, k), 1e30, dtype=dtype)
    top_i = torch.full((nq, k), -1, dtype=torch.int64)
    counts = torch.zeros((3, nq), dtype=torch.int64)
    totals = torch.zeros(4, dtype=torch.int64)
    blocks = []
    for t in range(4):
        stage = rng.choice(np.array([0, 1, 2, 2], np.uint8), size=(nq, nb))
        if t == 3:
            stage[:, nb - 7 :] = PAD_STAGE  # the ragged tail
        if t == 1:
            stage[:, :] = 0  # nothing survives LB_Keogh
        dvals = rng.integers(0, 4, size=(nq, nb)).astype(np.float64) * 0.5
        dvals[stage != 2] = np.nan
        blocks.append((t * nb, stage, dvals))
        block_merge_plain(top_v, top_i, counts, totals, torch.as_tensor(stage),
                          torch.as_tensor(dvals, dtype=dtype), t * nb, chunk)
    want_v, want_i, want_counts, want_totals = reference_merge_blocks(
        np.full((nq, k), 1e30), np.full((nq, k), -1, np.int64), blocks, k, chunk)
    np.testing.assert_array_equal(top_i.numpy(), want_i)
    np.testing.assert_array_equal(top_v.numpy(), want_v.astype(top_v.numpy().dtype))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(totals.numpy(), want_totals)


@pytest.mark.parametrize("with_bounds", [False, True])
@pytest.mark.parametrize("p", [1, 2, math.inf])
def test_masked_dtw_plain_runs_live_slots_only(p, with_bounds):
    """Live slots equal the pair-list DP of the same pairs (bounds from a
    strided column, as the loop's top-k gives them); dead slots keep the
    value they had."""
    rng = np.random.default_rng(12)
    qs, cands = torch.as_tensor(walks(rng, 4)), torch.as_tensor(walks(rng, 9))
    stage = torch.as_tensor(rng.choice(np.array([0, 1, 2, 255], np.uint8), size=(4, 9)))
    full = dtw_pairs_op(qs, cands, torch.arange(4).repeat_interleave(9),
                        torch.arange(9).repeat(4), W, p).reshape(4, 9)
    top = torch.stack([full.median(dim=1).values, full.median(dim=1).values], dim=1)
    bounds = top[:, -1] if with_bounds else None  # stride 2
    qi, ci = (stage == 2).nonzero(as_tuple=True)
    b = None if bounds is None else bounds[qi]
    for dp in (None, dtw_wavefront_plain):
        out = torch.full((4, 9), math.nan)
        if dp is None:  # the CPU route's DP, dtw_plain
            got = dtw_masked_plain(qs, cands, stage, W, p, bounds, out)
            want = dtw_pairs_op(qs, cands, qi, ci, W, p, b)
            exact = dtw_pairs_op(qs, cands, qi, ci, W, p)
        else:
            got = dtw_masked_plain(qs, cands, stage, W, p, bounds, out, dp=dp)
            want = dp(qs, cands, W, p, qi, ci, b)
            exact = dp(qs, cands, W, p, qi, ci)
        assert got is out
        assert torch.equal(out[qi, ci], want)
        assert bool(out[stage != 2].isnan().all())
        if b is not None:  # finished lanes exact, abandoned ones >= their bound
            below = exact < b
            assert torch.equal(want[below], exact[below])
            assert bool((want[~below] >= b[~below]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 5])
def test_plain_merge_with_lb_kim_first_equals_the_reference_numpy_merge(k, dtype):
    """The merge of ``kim_improved``'s three LB stages: counts (4, Q), the
    survivors at stage 3; a block pruned whole by LB_Kim counts in no
    blocks_lb2, one with a pair past it does."""
    rng = np.random.default_rng(13 + k)
    nq, nb, chunk = 6, 24, 5
    top_v = torch.full((nq, k), 1e30, dtype=dtype)
    top_i = torch.full((nq, k), -1, dtype=torch.int64)
    counts = torch.zeros((4, nq), dtype=torch.int64)
    totals = torch.zeros(4, dtype=torch.int64)
    blocks = []
    for t in range(5):
        stage = rng.choice(np.array([0, 1, 2, 3, 3], np.uint8), size=(nq, nb))
        if t == 1:
            stage[:, :] = 0  # all pruned by LB_Kim
        if t == 2:
            stage[:, :] = 0
            stage[2, 5] = 1  # one pair past LB_Kim
        if t == 4:
            stage[:, nb - 7 :] = PAD_STAGE
        dvals = rng.integers(0, 4, size=(nq, nb)).astype(np.float64) * 0.5
        dvals[stage != 3] = np.nan
        blocks.append((t * nb, stage, dvals))
        block_merge_plain(top_v, top_i, counts, totals, torch.as_tensor(stage),
                          torch.as_tensor(dvals, dtype=dtype), t * nb, chunk)
    want_v, want_i, want_counts, want_totals = reference_merge_blocks(
        np.full((nq, k), 1e30), np.full((nq, k), -1, np.int64), blocks, k, chunk, n_lb=3)
    np.testing.assert_array_equal(top_i.numpy(), want_i)
    np.testing.assert_array_equal(top_v.numpy(), want_v.astype(top_v.numpy().dtype))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(totals.numpy(), want_totals)
    assert int(totals[0]) == 4  # blocks 0, 2, 3, 4


@pytest.mark.parametrize("early_abandon", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_kim_loop_counts_blocks_that_lb_kim_prunes_whole(k, early_abandon, loop_calls):
    """Two whole blocks lie far from every query (and one more row in a
    third), so LB_Kim prunes them before LB_Keogh runs: the loop's
    per-stage counts and blocks_lb2 equal the reference's, and it
    prunes by LB_Kim at p = 1 too."""
    rng = np.random.default_rng(21 + k)
    db, qs = walks(rng, N_DB), walks(rng, 5)
    db[64:128] += 400.0
    db[200] -= 400.0
    jres = jcas.nn_search_host(qs, db, W, 1, k, BLOCK, CHUNK, "kim_improved",
                               early_abandon=early_abandon)
    tres = tcas.nn_search_host(qs, db, W, 1, k, BLOCK, CHUNK, "kim_improved",
                               early_abandon=early_abandon, device="cpu")
    assert loop_calls == [True]
    assert_same(jres, tres)
    s = tres.stats
    assert s.blocks_lb2 == s.blocks_total - 2
    assert s.stage_pruned[0] >= 5 * (2 * BLOCK + 1)


@pytest.mark.parametrize("early_abandon", [False, True])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_kim_webb_host_loop_prunes_as_the_kim_loop(k, p, early_abandon, loop_calls):
    """kim_webb keeps the host loop, LB_Kim alone per block.  Every block
    meets the same k-th best there as in kim_improved's device loop (both
    answer exactly over the rows before it), so LB_Kim and LB_Keogh prune
    the same lanes and blocks in both, and the answers are equal."""
    rng = np.random.default_rng(31 + k)
    db, qs = walks(rng, N_DB), walks(rng, 5)
    db[64:128] += 400.0
    args = (qs, db, W, p, k, BLOCK, CHUNK)
    kim = tcas.nn_search_host(*args, "kim_improved", early_abandon=early_abandon,
                              device="cpu")
    webb = tcas.nn_search_host(*args, "kim_webb", early_abandon=early_abandon, device="cpu")
    assert loop_calls == [True]
    np.testing.assert_array_equal(webb.indices, kim.indices)
    np.testing.assert_array_equal(webb.distances, kim.distances)
    assert webb.stats.stage_pruned[:2] == kim.stats.stage_pruned[:2]
    assert webb.stats.blocks_lb2 == kim.stats.blocks_lb2 < kim.stats.blocks_total


@pytest.mark.parametrize("real", [BLOCK, BLOCK - 5])
@pytest.mark.parametrize("p", [1, 2])
def test_kim_stage_plain_matches_the_host_masks(p, real):
    """The stage of K4's kim entry from float32 bounds sorts the pairs as
    the host loop's float64 masks of the three stages did: 0 pruned by
    LB_Kim, 1 by LB_Keogh, 2 by LB_Improved, 3 survivor; pad rows 255;
    pass 2 kept only where LB_Kim and lb1 are below the bound."""
    rng = np.random.default_rng(19 + p)
    cands, qs = torch.as_tensor(walks(rng, BLOCK)), torch.as_tensor(walks(rng, 6))
    cands[::3] += 3.0  # some pairs far apart at their ends: LB_Kim prunes them
    upper, lower = envelope_plain(qs, W)
    kim = lb_kim_plain(cands, qs, None, p)
    lb1_all, _ = lb_fused_plain(cands, qs, upper, lower, W, torch.full((6,), math.inf), p)
    bound64 = np.quantile(lb1_all.numpy(), 0.5, axis=1).astype(np.float32).astype(np.float64)
    bound64[1], bound64[2] = 1e30, 0.0
    bound32 = torch.as_tensor(bound64, dtype=torch.float32)
    lb1, lb = lb_fused_plain(cands, qs, upper, lower, W, bound32, p, kim)
    stage = lb_fused_stage_plain(lb1, lb, bound32, real, kim).numpy()
    alive0 = kim.numpy() < bound64[:, None]
    alive1 = alive0 & (lb1.numpy() < bound64[:, None])
    alive2 = alive1 & (lb.numpy() < bound64[:, None])
    _, lb_nokim = lb_fused_plain(cands, qs, upper, lower, W, bound32, p)
    np.testing.assert_array_equal(lb.numpy(), np.where(alive0, lb_nokim.numpy(), lb1.numpy()))
    assert stage.dtype == np.uint8
    np.testing.assert_array_equal(stage[:, real:], PAD_STAGE)
    r = slice(0, real)
    np.testing.assert_array_equal(stage[:, r] == 0, ~alive0[:, r])
    np.testing.assert_array_equal(stage[:, r] == 1, (alive0 & ~alive1)[:, r])
    np.testing.assert_array_equal(stage[:, r] == 2, (alive1 & ~alive2)[:, r])
    np.testing.assert_array_equal(stage[:, r] == 3, alive2[:, r])
    assert {0, 1, 2, 3} <= set(np.unique(stage[:, r]).tolist())


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [37, 1000])
def test_kim_features_plain_matches_reference_pieces(n, offset):
    """The feature phase's plain version gives each row's first, last,
    max and min as ``repro.core.lb.lb_kim_powered`` takes them, exactly;
    the bound the kernel forms from them is ``lb_kim_plain`` bit for bit
    and the reference's within rtol 2e-4 (the LB_Kim kernels' tolerance),
    rows sliced at an odd offset included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n + offset)
    rows = walks(rng, 9 + offset, n)[offset:]
    cands, qs = rows[:6], rows[6:]
    feats = lb_kim_features_plain(torch.as_tensor(rows)).numpy()
    j = jnp.asarray(rows)
    want = np.stack([np.asarray(j[:, 0]), np.asarray(j[:, -1]),
                     np.asarray(jnp.max(j, axis=-1)), np.asarray(jnp.min(j, axis=-1))], axis=1)
    np.testing.assert_array_equal(feats, want)
    for p in (1, 2, math.inf):
        cf, qf = feats[:6], feats[6:]
        d = np.abs(cf[None, :, :] - qf[:, None, :])
        cost = d if p != 2 else d * d
        ext = np.maximum(cost[..., 2], cost[..., 3])
        if p == math.inf:
            lb = np.maximum(np.maximum(cost[..., 0], cost[..., 1]), ext)
        else:
            lb = np.maximum(cost[..., 0] + cost[..., 1], ext)
        got = lb_kim_plain(torch.as_tensor(cands), torch.as_tensor(qs), None, p).numpy()
        np.testing.assert_array_equal(lb, got)
        ref = np.asarray(jlb.lb_kim_powered_qbatch(jnp.asarray(cands), jnp.asarray(qs), p))
        np.testing.assert_allclose(got, ref, rtol=2e-4)
