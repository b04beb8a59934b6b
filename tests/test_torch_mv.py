"""repro_torch's multivariate tier (``repro_torch.mv``, the channel
folding of the kernel wrappers, the composed device loop) against
``repro.mv`` and the reference's drivers, on the CPU.

Dependent DTW on channel-major flattened rows (d channel segments of n
values a row).  The same inputs, made from a numpy seed, go through both
packages at small sizes (n <= 48, d in {1, 2, 3}).  Tolerances: layout,
envelopes and the channel folding of K1 bit-equal; LB_Keogh 1e-4;
LB_Improved, LB_Webb and tc_box 2e-4; the DP 3e-4 against the JAX twins
(2e-4 against the float64 oracle); drivers equal indices and counters,
distances within 2e-4.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import cascade as jcas  # noqa: E402
from repro.core import lb as jcore_lb  # noqa: E402
from repro.kernels.lb_improved.ops import (  # noqa: E402
    lb_improved_pass2_qbatch_op as j_pass2_op,
)
from repro.mv import dtw as jdtw  # noqa: E402
from repro.mv import envelope as jenv  # noqa: E402
from repro.mv import layout as jlayout  # noqa: E402
from repro.mv import lb as jlb  # noqa: E402
from repro.mv import tc as jtc  # noqa: E402
from repro_torch import mv as tmv  # noqa: E402
from repro_torch.core import cascade as tcas  # noqa: E402
from repro_torch.core import dtw as tcore_dtw  # noqa: E402
from repro_torch.kernels.dtw import ops as tdtw  # noqa: E402
from repro_torch.kernels.envelope.ops import envelope_op  # noqa: E402
from repro_torch.kernels.lb_fused.ops import (  # noqa: E402
    lb_fused_prepare,
    lb_fused_qbatch_op,
    lb_fused_stage_plain,
)
from repro_torch.kernels.lb_improved import ops as tli  # noqa: E402
from repro_torch.kernels.lb_keogh.ops import lb_keogh_qbatch_op  # noqa: E402

torch.set_num_threads(1)

P_VALUES = [1, 2, math.inf]
P_IDS = ["p1", "p2", "pinf"]
D, N, W = 3, 20, 3


def walks(seed, rows, n, d):
    """(rows, n, d) random walks, channel-minor (the API layout)."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n, d)).astype(np.float32).cumsum(axis=1)


def flat(seed, rows, n=N, d=D):
    return np.ascontiguousarray(jlayout.flatten_channels(walks(seed, rows, n, d)))


def t(x):
    return torch.as_tensor(np.array(x))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- layout


def test_layout_round_trip_numpy_and_tensors():
    x = walks(1, 5, 11, D)
    f = tmv.flatten_channels(x)
    np.testing.assert_array_equal(f, jlayout.flatten_channels(x))
    for ch in range(D):
        np.testing.assert_array_equal(f[:, ch * 11 : (ch + 1) * 11], x[:, :, ch])
    np.testing.assert_array_equal(tmv.unflatten_channels(f, D), x)
    assert tmv.channel_segments(f, D).shape == (5, D, 11)
    assert tmv.num_channels(x) == D and tmv.num_channels(x[0, :, 0]) == 1
    ft = tmv.flatten_channels(torch.as_tensor(x))
    assert torch.equal(ft, torch.as_tensor(f))
    assert torch.equal(tmv.unflatten_channels(ft, D), torch.as_tensor(x))
    with pytest.raises(ValueError, match="multiple"):
        tmv.unflatten_channels(f[:, :-1], D)


def test_flatten_d1_is_identity():
    x = walks(2, 4, 9, 1)[:, :, 0]
    got = tmv.flatten_channels(x[:, :, None])
    assert got.tobytes() == x.tobytes()
    assert torch.equal(tmv.flatten_channels(torch.as_tensor(x)[:, :, None]),
                       torch.as_tensor(x))


# -------------------------------------------------------------- envelopes


@pytest.mark.parametrize("d", [1, 2, 3])
def test_envelope_batch_mv_bit_equal(d):
    x = flat(3, 5, d=d)
    for w in (0, 2, N - 1, N + 4):
        ju, jl = jenv.envelope_batch_mv(jnp.asarray(x), w, d)
        tu, tl = tmv.envelope_batch_mv(t(x), w, d)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        # the op folds the channels into K1's batch, (..., d*n) leading axes kept
        fu, fl = envelope_op(t(x)[None], w, d)
        assert torch.equal(fu[0], tu) and torch.equal(fl[0], tl)
    u1, l1 = tmv.envelope_mv(t(x[0]), 2, d)
    np.testing.assert_array_equal(u1.numpy(), np.asarray(jenv.envelope_mv(jnp.asarray(x[0]), 2, d)[0]))
    np.testing.assert_array_equal(l1.numpy(), np.asarray(jenv.envelope_mv(jnp.asarray(x[0]), 2, d)[1]))


# ------------------------------------------------------------- DTW twins


@pytest.mark.parametrize("p", P_VALUES, ids=P_IDS)
def test_dtw_twins_match_repro_and_oracle(p):
    db, qs = walks(5, 6, N, D), walks(6, 2, N, D)
    qf, cf = tmv.flatten_channels(qs), tmv.flatten_channels(db)
    for w in (0, W, N):  # w >= n: the unconstrained clamp
        ref = np.array([[tmv.dtw_reference_mv(q, c, w, p) for c in db] for q in qs])
        assert ref[0, 0] == jdtw.dtw_reference_mv(qs[0], db[0], w, p)
        got_q = tmv.dtw_qbatch_mv(t(qf), t(cf), w, p, d=D).numpy()
        close(got_q, ref, 2e-4, 1e-5)
        close(got_q, jdtw.dtw_qbatch_mv(jnp.asarray(qf), jnp.asarray(cf), w, p, d=D), 3e-4)
        close(tmv.dtw_batch_mv(t(qf[0]), t(cf), w, p, d=D).numpy(), ref[0], 2e-4, 1e-5)
        pair = tmv.dtw_banded_diag_mv if p == math.inf else tmv.dtw_banded_mv
        close(float(pair(t(qf[0]), t(cf[0]), w, p, d=D)), ref[0, 0], 2e-4, 1e-5)
        close(tmv.dtw_banded_diag_mv(t(qf), t(cf[:2]), w, p, d=D).numpy(), ref[[0, 1], [0, 1]],
              2e-4, 1e-5)
    # d = 1 is the univariate program
    x, y = qf[:, :N], cf[:2, :N]
    assert torch.equal(tmv.dtw_qbatch_mv(t(x), t(y), W, p, d=1), tcore_dtw.dtw_qbatch(t(x), t(y), W, p))
    assert tmv.dtw_reference_mv(x[0], y[0], W, p) == tmv.dtw_reference_mv(x[0][:, None],
                                                                          y[0][:, None], W, p)


@pytest.mark.parametrize("p", [1, 2], ids=P_IDS[:2])
def test_dtw_banded_early_mv_contract(p):
    db, qs = walks(7, 8, N, D), walks(8, 1, N, D)
    qf, cf = tmv.flatten_channels(qs)[0], tmv.flatten_channels(db)
    exact = np.array([tmv.dtw_reference_mv(qs[0], c, W, p) for c in db]) ** p
    for bound in (np.inf, np.median(exact), exact.min() * 0.5):
        got = tmv.dtw_banded_early_mv(t(qf)[None].expand(8, -1), t(cf), W,
                                      np.float32(min(bound, 1e30)), p, D).numpy()
        want = np.asarray(jdtw.dtw_banded_early_mv(jnp.asarray(qf), jnp.asarray(cf[0]), W,
                                                   jnp.float32(min(bound, 1e30)), p, D))
        close(got[0], want, 2e-4, 1e-5)
        for g, ref in zip(got, exact):
            if ref < bound:
                close(g, ref, 2e-4, 1e-5)
            else:
                assert g >= min(bound, ref) * (1 - 1e-4)


# ------------------------------------------------------------------ bounds


@pytest.mark.parametrize("p", P_VALUES, ids=P_IDS)
@pytest.mark.parametrize("d", [2, 3])
def test_mv_bounds_match_repro(d, p):
    cs, qs = flat(9, 7, d=d), flat(10, 3, d=d)
    ju, jl = jenv.envelope_batch_mv(jnp.asarray(qs), W, d)
    tu, tl = t(ju), t(jl)
    close(tmv.lb_keogh_mv_powered(t(cs)[None], tu[:, None], tl[:, None], p).numpy(),
          jlb.lb_keogh_mv_powered(jnp.asarray(cs)[None], ju[:, None], jl[:, None], p), 1e-4)
    close(tmv.lb_kim_mv_powered(t(cs)[None], t(qs)[:, None], p).numpy(),
          jlb.lb_kim_mv_powered(jnp.asarray(cs)[None], jnp.asarray(qs)[:, None], p), 2e-4)
    for a, b in zip(tmv.envelope_of_envelopes_mv(tu, tl, W, d),
                    jlb.envelope_of_envelopes_mv(ju, jl, W, d)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    close(tmv.lb_improved_mv_powered_qbatch(t(cs), t(qs), tu, tl, W, p, d).numpy(),
          jlb.lb_improved_mv_powered_qbatch(jnp.asarray(cs), jnp.asarray(qs), ju, jl, W, p, d),
          2e-4)
    close(tmv.lb_webb_mv_powered_qbatch(t(cs), t(qs), tu, tl, W, p, d).numpy(),
          jlb.lb_webb_mv_powered_qbatch(jnp.asarray(cs), jnp.asarray(qs), ju, jl, W, p, d),
          2e-4)


@pytest.mark.parametrize("p", P_VALUES, ids=P_IDS)
def test_tc_box_matches_repro_and_sandwich(p):
    db, qs = walks(11, 10, N, D), walks(12, 2, N, D)
    qf, cf = tmv.flatten_channels(qs), tmv.flatten_channels(db)
    tu, tl = tmv.envelope_batch_mv(t(qf), W, D)
    box = tmv.tc_box_powered_qbatch(t(cf), tu, tl, p, D)
    close(box.numpy(), jtc.tc_box_powered_qbatch(jnp.asarray(cf), jnp.asarray(tu.numpy()),
                                                 jnp.asarray(tl.numpy()), p, D), 2e-4)
    assert tmv.box_segments(N) == jtc.box_segments(N) and tmv.TC_BOX_SEGMENTS == 8
    # the pair form bit-matches the dense tile
    qi, ci = torch.tensor([0, 1, 1, 0]), torch.tensor([3, 0, 9, 9])
    pair = tmv.tc_box_powered_pair(t(cf)[ci], tu[qi], tl[qi], p, D)
    assert torch.equal(pair, box[qi, ci])
    keogh = tmv.lb_keogh_mv_powered(t(cf)[None], tu[:, None], tl[:, None], p).numpy()
    box = box.numpy()
    assert (box <= keogh + 1e-4 * np.maximum(1.0, np.abs(keogh))).all()
    assert (box > 0).any(), "the box never fires on separated walks"
    for i, q in enumerate(qs):
        for j, c in enumerate(db):
            ref = tmv.dtw_reference_mv(q, c, W, p)
            ref = ref if p in (1, math.inf) else ref**p
            assert box[i, j] <= ref + 1e-4 * max(1.0, abs(ref))


@pytest.mark.parametrize("p", P_VALUES, ids=P_IDS)
def test_tc_tri_matches_repro(p):
    rng = np.random.default_rng(13)
    dq, dqw = rng.random((3, 4)).astype(np.float32), rng.random((3, 4)).astype(np.float32) * 4
    dr, drw = rng.random((4, 9)).astype(np.float32), rng.random((4, 9)).astype(np.float32) * 4
    c_w = np.float32(2.5)
    want = jtc.tc_tri_powered_qbatch(*map(jnp.asarray, (dq, dqw, dr, drw, c_w)), p)
    got = tmv.tc_tri_powered_qbatch(t(dq), t(dqw), t(dr), t(drw), torch.tensor(c_w), p)
    close(got.numpy(), want, 1e-6)
    qi, ci = torch.tensor([0, 2, 1]), torch.tensor([8, 0, 4])
    pair = tmv.tc_tri_powered_pair(t(dq)[qi], t(dqw)[qi], t(dr)[:, ci].T, t(drw)[:, ci].T,
                                   torch.tensor(c_w), p)
    assert torch.equal(pair, got[qi, ci])


# ------------------------------------------------- K3 folded, K5's channels


@pytest.mark.parametrize("p", P_VALUES, ids=P_IDS)
@pytest.mark.parametrize("d", [2, 3])
def test_folded_pass2_matches_repro_op(d, p):
    """The folded K3 (channels as rows, the per-channel terms summed, maxed
    at p = inf) against the reference op run in interpret mode; at p = inf,
    where the reference's kernels compute d ** p (ROADMAP.md, fault K2),
    against its jnp pass 2 on per-segment envelopes instead."""
    cs, qs = flat(14, 9, d=d), flat(15, 3, d=d)
    ju, jl = jenv.envelope_batch_mv(jnp.asarray(qs), W, d)
    _, h = lb_keogh_qbatch_op(t(cs), t(ju), t(jl), p)
    got = tli.lb_improved_pass2_qbatch_op(h, t(qs), W, p, d)
    hj = jnp.asarray(h.numpy())
    if p == math.inf:
        hu, hl = jenv.envelope_batch_mv(hj.reshape(-1, hj.shape[-1]), W, d)
        want = jcore_lb.lb_keogh_powered(jnp.asarray(qs)[:, None], hu.reshape(hj.shape),
                                         hl.reshape(hj.shape), p)
    else:
        want = j_pass2_op(hj, jnp.asarray(qs), W, p, interpret=True, d=d)
    close(got.numpy(), want, 2e-4)
    # the pair form: the same folding per explicit row
    qi = torch.tensor([2, 0, 1, 2])
    ci = torch.tensor([0, 8, 4, 4])
    pairs = tli.lb_improved_pass2_pairs_op(h[qi, ci].contiguous(), t(qs), qi, W, p, d)
    assert torch.equal(pairs, got[qi, ci])
    # the full bound through the qbatch op
    full = tli.lb_improved_qbatch_op(t(cs), t(qs), t(ju), t(jl), W, p, d=d)
    close(full.numpy(), jlb.lb_improved_mv_powered_qbatch(
        jnp.asarray(cs), jnp.asarray(qs), ju, jl, W, p, d), 2e-4)


@pytest.mark.parametrize("p", P_VALUES, ids=P_IDS)
@pytest.mark.parametrize("d,n,w", [(2, 17, 5), (3, 24, 23), (3, 20, 0)])
def test_wavefront_plain_channels_match_repro(d, n, w, p):
    """``dtw_wavefront_plain(d=)``, the kernel's own DP, against
    ``repro.mv.dtw.dtw_qbatch_mv`` (3e-4), with a band that reaches the
    grid's edge (w = n - 1); with bounds an abandoned lane returns a value
    >= its bound and the others their DP."""
    qs, cs = flat(16, 2, n, d), flat(17, 5, n, d)
    got = tdtw.dtw_wavefront_plain(t(qs), t(cs), w, p, d=d)
    want = jdtw.dtw_qbatch_mv(jnp.asarray(qs), jnp.asarray(cs), w, p, powered=True, d=d)
    close(got.numpy(), want, 3e-4)
    close(tdtw.dtw_plain(t(qs), t(cs), w, p, d=d).numpy(), want, 3e-4)
    # dtw_plain's CPU route is the op
    assert torch.equal(tdtw.dtw_qbatch_op(t(qs), t(cs), w, p, d=d),
                       tdtw.dtw_plain(t(qs), t(cs), w, p, d=d))
    qi, ci = torch.tensor([0, 1, 1, 0, 1]), torch.tensor([0, 1, 2, 3, 4])
    exact = got[qi, ci]
    bounds = exact * torch.tensor([0.2, 0.9, 1.5, 0.5, 2.0])
    for dp in (tdtw.dtw_wavefront_plain, tdtw.dtw_plain):
        ab = dp(t(qs), t(cs), w, p, qi, ci, bounds, d=d)
        live = exact < bounds
        assert (ab[~live] >= bounds[~live]).all()
        close(ab[live].numpy(), exact[live].numpy(), 3e-4)


@pytest.mark.parametrize("p", [1, 2], ids=P_IDS[:2])
def test_composed_fused_step_and_stages(p):
    """K4's d > 1 form: K2 then the folded K3, pass 2 kept where lb1 <
    bound, and the prepared launcher's stages (0, 1, 2, 255 past ``real``)."""
    cs, qs = flat(18, 12), flat(19, 3)
    ju, jl = jenv.envelope_batch_mv(jnp.asarray(qs), W, D)
    lb1, h = lb_keogh_qbatch_op(t(cs), t(ju), t(jl), p)
    lb2 = tli.lb_improved_pass2_qbatch_op(h, t(qs), W, p, D)
    bounds = lb1.median(dim=1).values
    f1, f = lb_fused_qbatch_op(t(cs), t(qs), t(ju), t(jl), W, bounds, p, d=D)
    assert torch.equal(f1, lb1)
    assert torch.equal(f, torch.where(lb1 < bounds[:, None], lb1 + lb2, lb1))
    stage = torch.empty((3, 12), dtype=torch.uint8)
    run = lb_fused_prepare(t(qs), t(ju), t(jl), W, bounds, p, 12, stage, d=D)
    run(t(cs), 10)
    want = lb_fused_stage_plain(f1, f, bounds, 10)
    assert torch.equal(stage, want) and (stage[:, 10:] == 255).all()
    assert set(stage[:, :10].unique().tolist()) <= {0, 1, 2}
    with pytest.raises(ValueError, match="kim"):
        lb_fused_prepare(t(qs), t(ju), t(jl), W, bounds, p, 12, stage, kim=True, d=D)


@pytest.mark.parametrize("early", [False, True], ids=["exact", "early"])
@pytest.mark.parametrize("p", [1, 2], ids=P_IDS[:2])
def test_composed_device_loop_matches_repro_host(p, early):
    """The host driver's device loop at d = 3 (the composed K4 step, then
    K5's masked channel entry with the merge), here on the CPU through the
    plain versions, against ``repro.core.cascade.nn_search_host(d=3)``:
    the same indices and per-stage counters, distances within 2e-4."""
    db, qs = flat(20, 70, 24), flat(21, 4, 24)
    qs[1] = db[33] + 0.01
    jres = jcas.nn_search_host(qs, db, 4, p, 3, 16, 8, "lb_improved", early, D)
    tres = tcas.nn_search_host(qs, db, 4, p, 3, 16, 8, "lb_improved", early, D, device="cpu")
    np.testing.assert_array_equal(tres.indices, np.asarray(jres.indices))
    close(tres.distances, np.asarray(jres.distances), 2e-4)
    for a, b in zip((tres.stats, *tres.per_query), (jres.stats, *jres.per_query)):
        assert tuple(a.stage_pruned) == tuple(b.stage_pruned)
        assert (a.full_dtw, a.blocks_lb2, a.blocks_dtw, a.dp_lane_work, a.dp_lane_useful) == (
            b.full_dtw, b.blocks_lb2, b.blocks_dtw, b.dp_lane_work, b.dp_lane_useful)
    # the loop itself, called directly: the same answers and counters
    qs_t, db_t = t(qs), t(db)
    u, l = envelope_op(qs_t, 4, D)
    top_v, top_i, counts, totals = tcas.fused_block_loop(qs_t, db_t, u, l, 4, p, 3, 16, 8,
                                                         early, d=D)
    np.testing.assert_array_equal(top_i.numpy(), tres.indices)
    s = tres.stats
    assert counts.sum(dim=1).tolist() == [*s.stage_pruned, s.full_dtw]
    assert totals.tolist() == [s.blocks_lb2, s.blocks_dtw, s.dp_lane_work, s.dp_lane_useful]
