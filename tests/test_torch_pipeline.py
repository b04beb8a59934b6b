"""repro_torch's stage pipeline against repro.core.pipeline (CPU).

``run_block_stages`` on the same block, bound and entry mask in both
packages: the per-stage alive masks and counters must be equal, and the
distances must agree (rtol 3e-4) wherever they are below the lane's bound
(an early-abandoned DP lane only promises a value >= its bound).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.envelope import envelope_batch as j_envelope_batch  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402

torch.set_num_threads(1)

METHODS = sorted(tpipe.PIPELINES)


def block_inputs(seed, nq=4, block=32, n=48, w=5):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(nq, n)).astype(np.float32).cumsum(axis=1)
    blk = rng.normal(size=(block, n)).astype(np.float32).cumsum(axis=1)
    return qs, blk, w


def run_both(qs, blk, w, p, method, bound, mask0, lane_chunk=32):
    ju, jl = j_envelope_batch(jnp.asarray(qs), w)
    js = jpipe.run_block_stages(
        jnp.asarray(qs), ju, jl, w, p, method, jnp.asarray(blk),
        jnp.asarray(bound), jnp.asarray(mask0), lane_chunk=lane_chunk,
    )
    ts = tpipe.run_block_stages(
        torch.as_tensor(qs), torch.as_tensor(np.array(ju)),
        torch.as_tensor(np.array(jl)), w, p, method, torch.as_tensor(blk),
        torch.as_tensor(bound), torch.as_tensor(mask0), lane_chunk=lane_chunk,
    )
    return js, ts


def assert_same(js, ts, bound):
    assert len(js.masks) == len(ts.masks)
    for jm, tm in zip(js.masks, ts.masks):
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    assert bool(js.need_lb2) == ts.need_lb2
    assert bool(js.need_dtw) == ts.need_dtw
    assert int(js.dp_lane_work) == ts.dp_lane_work
    assert int(js.dp_lane_useful) == ts.dp_lane_useful
    jd, td = np.asarray(js.d), ts.d.numpy()
    keep = jd < bound[:, None]
    np.testing.assert_allclose(td[keep], jd[keep], rtol=3e-4)
    np.testing.assert_array_equal(td < bound[:, None], keep)


def bound_for(qs, blk, w, p, quantile):
    """A per-query bound at a quantile of the block's true distances, so
    every stage prunes some lanes and keeps others."""
    d = np.asarray(jpipe.STAGES["full"].dense(
        jpipe.PipeContext(jnp.asarray(qs), None, None, w, p), jnp.asarray(blk)))
    return np.quantile(d, quantile, axis=1).astype(np.float32)


@pytest.mark.parametrize("p", [1, 2, math.inf])
@pytest.mark.parametrize("method", METHODS)
def test_run_block_stages_matches_jax(method, p):
    qs, blk, w = block_inputs(1)
    bound = bound_for(qs, blk, w, p, 0.2)
    mask0 = np.ones((qs.shape[0], blk.shape[0]), bool)
    mask0[1, 5:9] = False  # entry-masked lanes are neither run nor counted
    js, ts = run_both(qs, blk, w, p, method, bound, mask0)
    assert_same(js, ts, bound)


@pytest.mark.parametrize("quantile", [0.02, 0.9])
def test_compacted_and_dense_paths(quantile):
    """A tight bound keeps few lanes (chunked path); a loose one keeps most
    (the dense fallback past half the lanes)."""
    qs, blk, w = block_inputs(2)
    bound = bound_for(qs, blk, w, 1, quantile)
    mask0 = np.ones((qs.shape[0], blk.shape[0]), bool)
    for chunk in (8, 32):
        js, ts = run_both(qs, blk, w, 1, "lb_improved", bound, mask0, chunk)
        assert_same(js, ts, bound)


def test_compact_order_is_stable_alive_first():
    alive = torch.tensor([False, True, False, True, True, False, True])
    order = tpipe._compact_order(alive).tolist()
    assert order == [1, 3, 4, 6, 0, 2, 5]
    big = torch.as_tensor(np.random.default_rng(3).random(500) < 0.3)
    order = tpipe._compact_order(big)
    n_alive = int(big.sum())
    assert bool(big[order[:n_alive]].all())
    assert order[:n_alive].tolist() == sorted(order[:n_alive].tolist())
    assert order[n_alive:].tolist() == sorted(order[n_alive:].tolist())


def test_registry_matches_reference_and_rejects_mv():
    for method, stages in tpipe.PIPELINES.items():
        assert jpipe.PIPELINES[method] == stages
        assert tpipe.lb_stage_names(method) == jpipe.lb_stage_names(method)
    for method in ("tc_box", "tc_tri"):
        assert tpipe.lb_stage_names(method) == jpipe.lb_stage_names(method)
    # d = 2 channels of 4 values: the block runs, with the reference's masks
    from repro.mv.envelope import envelope_batch_mv as j_envelope_mv

    qs, blk, w = block_inputs(4, nq=1, block=4, n=8, w=1)
    ju, jl = j_envelope_mv(jnp.asarray(qs), w, 2)
    bound = np.full(1, 1e30, np.float32)
    mask0 = np.ones((1, 4), bool)
    js = jpipe.run_block_stages(jnp.asarray(qs), ju, jl, w, 1, "tc_box", jnp.asarray(blk),
                                jnp.asarray(bound), jnp.asarray(mask0), d=2)
    ts = tpipe.run_block_stages(
        torch.as_tensor(qs), torch.as_tensor(np.array(ju)), torch.as_tensor(np.array(jl)),
        w, 1, "tc_box", torch.as_tensor(blk), torch.as_tensor(bound),
        torch.as_tensor(mask0), d=2,
    )
    for jm, tm in zip(js.masks, ts.masks):
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_allclose(ts.d.numpy(), np.asarray(js.d), rtol=3e-4)
