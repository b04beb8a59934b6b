"""repro_torch's CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc: a CUDA kernel has no CPU build, so
every test here is marked ``cuda`` and skips with a reason elsewhere.
Run them on the card with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py`` (the file imports no JAX).  Tolerances:
envelope and H bit-equal, LB_Keogh rtol 1e-4, LB_Improved 2e-4, DP 3e-4
against the reference's row DP.  The DP kernel (K5) is bit-equal to its
wavefront plain version on every lane, finished or abandoned, and to
``core.dtw.dtw_banded_diag`` on finished ones.
LB_Kim (K6: a warp per row for the features, then the last block's
lanes) is bit-equal by design (exact max/min, no fused multiply-add), at
any row alignment and every tile, as is K4's kim entry to LB_Kim, then K2
plus K3 on the lanes LB_Kim leaves;
the fused kernel (K4, one warp per pair) is bit-equal to LB_Keogh (K2)
plus pass 2 (K3), because its pass-2 routine adds K3's terms in K3's
order, and the stream entry (K7) to K2 on the copied windows; every
schedule in a family's tune space gives the same bits.  The masked-dense
K5 entry is bit-equal to the pair-list entry on its live slots and
writes no other slot; with the merge as its epilogue it is bit-equal to
``dtw_masked_plain`` (the kernel's wavefront DP) then
``block_merge_plain``, ties included, as is the standalone merge kernel;
the host driver's fused loop runs on the card with two launches per
block (K4, then K5 with the merge) and no synchronisation.  The envelope
kernel (K1: a block per row up to ``SMALL_ROWS`` rows, else one warp per
row, chunked van Herk–Gil–Werman) is bit-equal to its plain version on
both paths, at the chunk edges of ``envelope_chunk``.  K3 (one warp per
row on the same scans) is bit-equal to its stated sum order, that of a
256-thread block, at p = 1 and inf.  Past their shared-memory forms, K1,
K3, K4 and K5 take long-row paths by shape; the ``long`` tests hold each
to its plain version at float32 n = 12,288 and float64 n = 6,144 (w =
n // 10 and n - 1), K5 also past its register path (n = 32,768) and with
its diagonals in the workspace, and the device loop with K4 on its
long-row path.  K5's channel entry (multivariate rows, the cell cost
summed over d channels) is bit-equal to ``dtw_wavefront_plain(d=)`` on
its staged and in-place paths and, masked with the merge, to
``dtw_merge_plain(d=)``; the multivariate device loop runs K2, the folded
K3 and K5's channel entry per block with no synchronisation.  K7's
channel entry (K7c, a (d, L) stream segment) is bit-equal to its plain
version and to K2 on the gathered (B, d*n) tile, and a d-channel stream
scanner on the card gives the CPU scanner's matches and counters.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.core.dtw import dtw_banded_diag  # noqa: E402
from repro_torch.kernels import block_merge as kb  # noqa: E402
from repro_torch.kernels import dtw as kd  # noqa: E402
from repro_torch.kernels import envelope as ke  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import lb_fused as kf  # noqa: E402
from repro_torch.kernels import lb_improved as ki  # noqa: E402
from repro_torch.kernels import lb_keogh as kk  # noqa: E402
from repro_torch.kernels import lb_kim as km  # noqa: E402
from repro_torch.kernels.common import NotRunnable  # noqa: E402
from repro_torch.kernels.tuning import (  # noqa: E402
    KernelConfig,
    TuneTable,
    search_space,
    use_table,
)

pytestmark = pytest.mark.cuda

PS = [1, 2, math.inf]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU build")
    return torch.device("cuda")


def walks(dev, seed, rows, n, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, n)).cumsum(axis=1)
    return torch.as_tensor(x, dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,n,w", [(16, 1000, 100), (7, 97, 5), (3, 2, 1), (4, 50, 49)])
def test_envelope_kernel_bit_equal(dev, rows, n, w, dtype):
    x = walks(dev, 1, rows, n, dtype)
    u, l = ke.envelope_launch(x, w)
    pu, pl = ke.envelope_plain(x, w)
    assert torch.equal(u, pu) and torch.equal(l, pl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,n,w", [
    (1, 1000, 100), (16, 1000, 100),  # one row; the search's queries
    (3, 1000, 12), (3, 1001, 12),     # n + 2w a multiple of 32, and not
    (5, 1000, 5), (5, 1000, 16),      # chunk 2w - 1: lanes own several chunks
    (5, 1000, 17), (2, 999, 998),     # chunk about (n + 2w) / 32; w = n - 1
    (4, 33, 1), (6, 131, 65),
])
def test_envelope_kernel_chunk_edges(dev, rows, n, w, dtype):
    """Bit-equal at the chunk edges of the warp per row
    (``envelope_chunk(n, w)``), rows of odd length (16-byte alignment
    varies by row), and a batch whose base is not 16-byte aligned: each
    shape as given (up to ``SMALL_ROWS`` rows: a block per row) and with
    ``SMALL_ROWS`` more rows (a warp per row)."""
    from repro_torch.kernels.envelope.ops import SMALL_ROWS, envelope_chunk

    assert envelope_chunk(n, w) % 2 == 1 and envelope_chunk(n, w) <= 2 * w - 1
    x = walks(dev, 2, rows + 1, n, dtype)
    wide = walks(dev, 3, SMALL_ROWS + rows + 1, n, dtype)
    for xs in (x[:rows], x[1:], wide[:-1], wide[1:]):
        u, l = ke.envelope_launch(xs, w)
        pu, pl = ke.envelope_plain(xs, w)
        assert torch.equal(u, pu) and torch.equal(l, pl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_envelope_kernel_long_rows(dev, dtype):
    """Rows whose two staging buffers do not fit (float64): one buffer."""
    x = walks(dev, 3, 3, 8000, dtype)
    u, l = ke.envelope_launch(x, 800)
    pu, pl = ke.envelope_plain(x, 800)
    assert torch.equal(u, pu) and torch.equal(l, pl)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lb_keogh_kernel(dev, p, dtype):
    cands, qs = walks(dev, 2, 33, 200, dtype), walks(dev, 3, 5, 200, dtype)
    u, l = ke.envelope_plain(qs, 20)
    u, l = u.contiguous(), l.contiguous()
    lb, h = kk.lb_keogh_launch(cands, u, l, p)
    plb, ph = kk.lb_keogh_plain(cands, u, l, p)
    torch.testing.assert_close(lb, plb, rtol=1e-4, atol=0)
    assert torch.equal(h, ph)
    qi = torch.tensor([0, 4, 2, 2], device=dev)
    ci = torch.tensor([32, 0, 7, 7], device=dev)
    lb, h = kk.lb_keogh_launch(cands, u, l, p, qi, ci)
    plb, ph = kk.lb_keogh_plain(cands, u, l, p, qi, ci)
    torch.testing.assert_close(lb, plb, rtol=1e-4, atol=0)
    assert torch.equal(h, ph)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("w", [0, 20, 500])
def test_lb_improved_pass2_kernel(dev, p, w):
    h, qs = walks(dev, 4, 4 * 9, 200).reshape(4, 9, 200), walks(dev, 5, 4, 200)
    got = ki.lb_improved_pass2_launch(h, qs, w, p)
    torch.testing.assert_close(got, ki.lb_improved_pass2_plain(h, qs, w, p),
                               rtol=2e-4, atol=0)
    rows = h.reshape(-1, 200)[:13].contiguous()
    qi = torch.arange(13, device=dev) % 4
    got = ki.lb_improved_pass2_launch(rows, qs, w, p, qi)
    torch.testing.assert_close(got, ki.lb_improved_pass2_plain(rows, qs, w, p, qi),
                               rtol=2e-4, atol=0)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,w", [(128, 12), (64, 0), (40, 100)])
def test_dtw_kernel(dev, p, dtype, n, w):
    qs, cands = walks(dev, 6, 3, n, dtype), walks(dev, 7, 11, n, dtype)
    got = kd.dtw_launch(qs, cands, w, p)
    want = kd.dtw_plain(qs, cands, w, p)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=0)
    qi = torch.tensor([2, 0, 1, 1], device=dev)
    ci = torch.tensor([10, 3, 3, 0], device=dev)
    full = kd.dtw_plain(qs, cands, w, p, qi, ci)
    bounds = (full * torch.tensor([0.5, 2.0, 0.9, 1.5], device=dev, dtype=dtype))
    got = kd.dtw_launch(qs, cands, w, p, qi, ci, bounds.contiguous())
    below = full < bounds
    torch.testing.assert_close(got[below], full[below], rtol=3e-4, atol=0)
    assert bool((got[~below] >= bounds[~below]).all())


def _pair_rows(qs, cands, qi, ci):
    if qi is None:
        nq, nb, n = qs.shape[0], cands.shape[0], qs.shape[1]
        return (qs[:, None, :].expand(nq, nb, n).reshape(-1, n),
                cands[None].expand(nq, nb, n).reshape(-1, n))
    return qs[qi], cands[ci]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,w,pairs", [
    (1000, 100, 16),   # the host driver's chunk
    (1000, 100, 1),    # a chunk of one pair
    (64, 0, 0), (64, 63, 0), (97, 31, 0), (97, 32, 0),  # dense 2 x 37 grids
    (1200, 600, 0),    # past the register cap: the shared-memory path
])
def test_dtw_kernel_bit_equal_wavefront(dev, p, dtype, n, w, pairs):
    qs, cands = walks(dev, 8, 2 if not pairs else 16, n, dtype), walks(dev, 9, 37, n, dtype)
    qi = ci = None
    if pairs:
        rng = np.random.default_rng(10)
        qi = torch.as_tensor(rng.integers(0, qs.shape[0], pairs), device=dev)
        ci = torch.as_tensor(rng.integers(0, 37, pairs), device=dev)
    got = kd.dtw_launch(qs, cands, w, p, qi, ci)
    want = kd.dtw_wavefront_plain(qs, cands, w, p, qi, ci)
    assert torch.equal(got, want)
    rows_q, rows_c = _pair_rows(qs, cands, qi, ci)
    diag = dtw_banded_diag(rows_q, rows_c, w, p, powered=True).reshape(got.shape)
    assert torch.equal(got, diag)
    torch.testing.assert_close(got, kd.dtw_plain(qs, cands, w, p, qi, ci), rtol=3e-4, atol=0)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,w", [(300, 20), (700, 600)])
def test_dtw_kernel_abandoned_lanes(dev, p, dtype, n, w):
    qs, cands = walks(dev, 11, 3, n, dtype), walks(dev, 12, 6, n, dtype)
    full = kd.dtw_wavefront_plain(qs, cands, w, p)
    scale = torch.tensor([0.2, 0.7, 0.95, 1.5, 2.0, 0.5], device=dev, dtype=dtype)
    for bounds in (full * scale, torch.zeros_like(full), torch.full_like(full, -1.0),
                   torch.full_like(full, kd.ops.BIG)):
        bounds = bounds.contiguous()
        got = kd.dtw_launch(qs, cands, w, p, bounds=bounds)
        assert torch.equal(got, kd.dtw_wavefront_plain(qs, cands, w, p, bounds=bounds))
        below = full < bounds
        assert torch.equal(got[below], full[below])
        assert bool((got[~below] >= bounds[~below]).all())


def test_default_session_launches_every_kernel(dev):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1100, 96)).cumsum(axis=1).astype(np.float32)
    q = rng.normal(size=(4, 96)).cumsum(axis=1).astype(np.float32)
    reset_launch_counts()
    db = Database.build(x, SearchConfig(k=3))
    built = launch_counts()
    reset_launch_counts()
    res = db.search(q)
    searched = launch_counts()
    # the build's envelopes and calibration probe, then the host driver:
    # envelopes, one fused LB launch per block and the DP chunks
    for name in ("envelope", "lb_kim", "lb_keogh", "lb_improved_pass2", "dtw"):
        assert built[name] > 0, built
    for name in ("envelope", "lb_fused", "dtw_merge"):
        assert searched[name] > 0, searched
    for name in ("lb_keogh", "lb_improved_pass2", "dtw", "block_merge"):
        assert searched[name] == 0, searched
    ref = Database.build(x, SearchConfig(k=3), device="cpu").search(q)
    np.testing.assert_array_equal(res.indices, ref.indices)
    np.testing.assert_allclose(res.distances, ref.distances, rtol=2e-4)


def envelopes(qs, w):
    u, l = ke.envelope_plain(qs, w)
    return u.contiguous(), l.contiguous()


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,n", [(37, 300), (1, 37), (37, 37), (1, 1000), (37, 1000),
                                  (1024, 1000), (37, 1001)])
def test_lb_kim_kernel_bit_equal(dev, p, dtype, nb, n):
    """K6 against its plain version with and without a mask (bool and
    float), at every tile, on rows as allocated and on the same buffer
    viewed one value further on: there, at n = 300 and 1,000, no row
    starts 16-byte aligned, so the feature phase takes its scalar path
    (at n = 1,000 in several batches of 256 values a lane); at n = 37 and
    1,001 the vector and scalar paths alternate between rows.  Its feature
    phase alone against lb_kim_features_plain."""
    rows = walks(dev, 30, nb + 7, n, dtype)
    shifted = rows.reshape(-1)[1:1 + (nb + 6) * n].view(nb + 6, n)
    assert shifted.data_ptr() % 16 != 0
    mask = torch.as_tensor(np.random.default_rng(32).random((6, nb)) < 0.6, device=dev)
    for label, src in (("as allocated", rows), ("one value on", shifted)):
        cands, qs = src[:nb], src[nb:nb + 6]
        assert torch.equal(km.lb_kim_launch(cands, qs, None, p),
                           km.lb_kim_plain(cands, qs, None, p)), label
        got = km.lb_kim_launch(cands, qs, mask, p)
        assert torch.equal(got, km.lb_kim_plain(cands, qs, mask, p)), label
        assert bool((got[~mask] == 1e30).all())
        assert torch.equal(km.lb_kim_launch(cands, qs, mask.to(dtype), p), got)
        for cfg in search_space("lb_kim"):
            assert torch.equal(km.lb_kim_launch(cands, qs, mask, p, cfg.tile_b), got), cfg
            assert torch.equal(km.lb_kim_features_launch(cands, cfg.tile_b),
                               km.lb_kim_features_plain(cands)), cfg


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("hop", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lb_keogh_stream_kernel(dev, p, hop, dtype):
    n, w = 120, 12
    seg = walks(dev, 33, 1, 40 * hop + n + 2, dtype)[0]
    qs = walks(dev, 34, 4, n, dtype)
    u, l = envelopes(qs, w)
    lb, h = kk.lb_keogh_stream_launch(seg, u, l, n, hop, p)
    plb, ph = kk.lb_keogh_stream_plain(seg, u, l, n, hop, p)
    torch.testing.assert_close(lb, plb, rtol=1e-4, atol=0)
    assert torch.equal(h, ph)
    # the strided entry runs K2's routine on the windows in place
    wins = kk.materialize_windows(seg, n, hop)
    klb, kh = kk.lb_keogh_launch(wins, u, l, p)
    assert torch.equal(lb, klb) and torch.equal(h, kh)
    for cfg in search_space("lb_keogh"):
        got = kk.lb_keogh_stream_launch(seg, u, l, n, hop, p, cfg.tile_b)
        assert torch.equal(got[0], lb) and torch.equal(got[1], h)
        got = kk.lb_keogh_launch(wins, u, l, p, tile_b=cfg.tile_b)
        assert torch.equal(got[0], klb) and torch.equal(got[1], kh)
    full = ki.lb_improved_stream_qbatch_op(seg, qs, u, l, n, w, hop, p)
    torch.testing.assert_close(
        full, ki.lb_improved_stream_plain(seg, qs, u, l, n, w, hop, p), rtol=2e-4, atol=0
    )


def fused_inputs(dev, dtype, p, nq=5, nb=37, n=200, w=20):
    cands, qs = walks(dev, 35, nb, n, dtype), walks(dev, 36, nq, n, dtype)
    u, l = envelopes(qs, w)
    lb1 = kk.lb_keogh_plain(cands, u, l, p)[0]
    bounds = lb1.median(dim=1).values.contiguous()  # about half the lanes live
    bounds[0] = 0.0  # query 0: no live lane, every tile skips pass 2
    return cands, qs, u, l, w, bounds


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lb_fused_kernel(dev, p, dtype):
    cands, qs, u, l, w, bounds = fused_inputs(dev, dtype, p)
    lb1, lb = kf.lb_fused_launch(cands, qs, u, l, w, bounds, p)
    # the plain version with no bound gives pass 2 on every lane; the
    # kernel's own lb1 decides which lanes are live (a lane at the median
    # bound can fall either side of it within rounding)
    plb1, plb = kf.lb_fused_plain(cands, qs, u, l, w, torch.full_like(bounds, math.inf), p)
    torch.testing.assert_close(lb1, plb1, rtol=1e-4, atol=0)
    dead = lb1 >= bounds[:, None]
    assert bool(dead[0].all()) and not bool(dead.all())
    assert torch.equal(lb[dead], lb1[dead])
    torch.testing.assert_close(lb[~dead], plb[~dead], rtol=2e-4, atol=0)
    # bit-equal to K2, then K3 and combine_passes
    klb1, h = kk.lb_keogh_launch(cands, u, l, p)
    lb2 = ki.lb_improved_pass2_launch(h, qs, w, p)
    assert torch.equal(lb1, klb1)
    assert torch.equal(lb, torch.where(dead, klb1, ki.combine_passes(klb1, lb2, p)))
    for cfg in search_space("lb_fused"):
        if kf.fused_smem_bytes(200, w, cfg.tile_b, cfg.grid, cands.element_size()) > 232_448:
            # a block of that many warps' buffers cannot launch: autotune
            # records the schedule as not runnable, and the same schedule
            # resolved from the table is halved until it fits
            with pytest.raises(NotRunnable):
                kf.lb_fused_launch(cands, qs, u, l, w, bounds, p, cfg.tile_b, cfg.depth,
                                   cfg.grid)
            with use_table(TuneTable(entries={("lb_fused", "cuda", "*"): cfg})):
                got = kf.lb_fused_launch(cands, qs, u, l, w, bounds, p)
            assert torch.equal(got[0], lb1) and torch.equal(got[1], lb), cfg
            continue
        got = kf.lb_fused_launch(cands, qs, u, l, w, bounds, p, cfg.tile_b, cfg.depth, cfg.grid)
        assert torch.equal(got[0], lb1) and torch.equal(got[1], lb), cfg


def test_lb_fused_refuses_what_cannot_launch(dev):
    cands, qs, u, l, w, bounds = fused_inputs(dev, torch.float32, 1)
    with pytest.raises(ValueError):
        kf.lb_fused_qbatch_op(cands, qs, u, l, w, bounds, math.inf)
    with pytest.raises(NotRunnable):
        kf.lb_fused_launch(cands, qs, u, l, w, bounds, 1, 8, 2, "qb")
    # 32 rows of H at n = 4000 exceed shared memory: an explicit tile
    # raises, a resolved one is halved until it fits
    c, q = walks(dev, 37, 9, 4000), walks(dev, 38, 2, 4000)
    cu, cl = envelopes(q, 400)
    b2 = torch.full((2,), 1e30, device=dev)
    with pytest.raises(NotRunnable):
        kf.lb_fused_launch(c, q, cu, cl, 400, b2, 1, 32, 1, "qb")
    table = TuneTable(entries={("lb_fused", "cuda", "*"): KernelConfig(tile_b=32)})
    with use_table(table):
        got = kf.lb_fused_launch(c, q, cu, cl, 400, b2, 1)
    want = kf.lb_fused_launch(c, q, cu, cl, 400, b2, 1, 1, 1, "qb")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("method,p", [
    ("lb_improved", 1), ("kim_improved", 1), ("kim_improved", 2), ("kim_improved", math.inf),
    ("kim_webb", 1),
], ids=["lb_improved", "kim_improved", "kim_improved-p2", "kim_improved-pinf", "kim_webb"])
def test_host_driver_fused_route(dev, method, p):
    """The host driver runs LB_Keogh -> LB_Improved as one K4 launch per
    block (for kim_improved at p in {1, 2} with LB_Kim as K4's entry) on
    the device-resident loop; kim_webb and p = inf keep the host loop, K6
    alone once per block.  Both give the CPU route's answers and
    counters."""
    from repro_torch.core.cascade import nn_search_host

    rng = np.random.default_rng(39)
    x = rng.normal(size=(300, 96)).cumsum(axis=1).astype(np.float32)
    x[64:128] += 400.0  # two blocks far from every query: LB_Kim prunes them whole
    q = rng.normal(size=(6, 96)).cumsum(axis=1).astype(np.float32)
    reset_launch_counts()
    got = nn_search_host(q, x, 9, p, 3, 32, method=method, device=dev)
    counts = launch_counts()
    want = nn_search_host(q, x, 9, p, 3, 32, method=method, device="cpu")
    s = got.stats
    if p in (1, 2) and method != "kim_webb":
        # the device-resident loop: K4 (for kim_improved with LB_Kim as its
        # entry, the query features once), K5 with the merge
        assert counts["lb_fused"] == counts["dtw_merge"] == s.blocks_total
        assert counts["lb_keogh"] == counts["lb_improved_pass2"] == 0
        assert counts["dtw"] == counts["block_merge"] == counts["lb_kim"] == 0
        assert counts["lb_kim_features"] == (1 if method == "kim_improved" else 0)
    else:
        # the host loop: K6 on every block, K2 on each block with lanes
        # left (blocks_lb2; at p = inf K3's stage adds more), the
        # survivors' DP on pair lists
        assert counts["lb_kim"] == s.blocks_total
        assert counts["lb_kim_features"] == counts["lb_fused"] == counts["dtw_merge"] == 0
        assert counts["lb_keogh"] >= s.blocks_lb2 > 0 and counts["dtw"] > 0
        assert s.blocks_lb2 < s.blocks_total
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.distances, want.distances, rtol=2e-4)
    assert got.stats == want.stats


def fused_reference(cands, qs, u, l, w, bounds, p):
    """K2, then K3 on every lane, kept where lb1 < bound."""
    klb1, h = kk.lb_keogh_launch(cands, u, l, p)
    lb2 = ki.lb_improved_pass2_launch(h, qs, w, p)
    live = klb1 < bounds.reshape(-1, 1)
    return klb1, torch.where(live, ki.combine_passes(klb1, lb2, p), klb1)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("nq,nb,n,w,dtype", [
    (1, 1, 2, 1, torch.float32), (3, 33, 64, 0, torch.float32),
    (2, 5, 300, 299, torch.float64), (16, 32, 1000, 100, torch.float32),
    (3, 9, 257, 40, torch.float64), (2, 9, 1000, 16, torch.float32),
    (2, 9, 1000, 17, torch.float32),
])
def test_lb_fused_warp_per_pair_every_schedule(dev, p, nq, nb, n, w, dtype):
    """K4 against K2 + K3 at edge shapes, for every schedule that fits,
    with strided bounds (a top-k column) and the stage output."""
    cands, qs = walks(dev, 40, nb, n, dtype), walks(dev, 41, nq, n, dtype)
    u, l = envelopes(qs, w)
    lb1 = kk.lb_keogh_plain(cands, u, l, p)[0]
    top = torch.stack([lb1.median(dim=1).values] * 3, dim=1).contiguous()
    bounds = top[:, -1]  # stride 3
    want = fused_reference(cands, qs, u, l, w, bounds, p)
    real = max(nb - 3, 1)
    stage_want = kf.lb_fused_stage_plain(*want, bounds, real)
    ran = 0
    for cfg in search_space("lb_fused"):
        if kf.fused_smem_bytes(n, min(w, n - 1), cfg.tile_b, cfg.grid,
                               cands.element_size()) > 232_448:
            continue
        got = kf.lb_fused_launch(cands, qs, u, l, w, bounds, p, cfg.tile_b, cfg.depth,
                                 cfg.grid, stage=True, real=real)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), cfg
        assert torch.equal(got[2], stage_want), cfg
        ran += 1
    assert ran > 0


@pytest.mark.parametrize("p", [1, 2])
def test_lb_fused_long_rows_one_warp(dev, p):
    """Rows whose per-warp buffers take most of shared memory launch at
    one warp per block (the parent's one-row block took as much)."""
    n, w = 8000, 800
    cands, qs = walks(dev, 42, 3, n), walks(dev, 43, 2, n)
    u, l = envelopes(qs, w)
    bounds = torch.full((2,), 1e30, device=dev)
    bounds[1] = 0.0
    got = kf.lb_fused_launch(cands, qs, u, l, w, bounds, p, 1, 1, "qb")
    want = fused_reference(cands, qs, u, l, w, bounds, p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(NotRunnable):
        kf.lb_fused_launch(cands, qs, u, l, w, bounds, p, 2, 1, "qb")


def kim_reference(cands, qs, u, l, w, bounds, p, real):
    """K4's kim entry from K2, K3 and K6's plain version: lb1 from K2 on
    every lane, pass 2 kept where LB_Kim and lb1 are below the bound, and
    the stage with LB_Kim first."""
    kim = km.lb_kim_plain(cands, qs, None, p)
    klb1, h = kk.lb_keogh_launch(cands, u, l, p)
    lb2 = ki.lb_improved_pass2_launch(h, qs, w, p)
    b = bounds.reshape(-1, 1)
    live = (kim < b) & (klb1 < b)
    lb = torch.where(live, ki.combine_passes(klb1, lb2, p), klb1)
    return klb1, lb, kf.lb_fused_stage_plain(klb1, lb, bounds, real, kim)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("nq,nb,n,w,dtype", [
    (16, 32, 1000, 100, torch.float32), (3, 33, 64, 0, torch.float32),
    (2, 5, 300, 299, torch.float64), (3, 9, 257, 40, torch.float64),
    (2, 5, 12_288, 1_228, torch.float32), (2, 5, 6_144, 6_143, torch.float64),
])
def test_lb_fused_kim_entry_bit_equal(dev, p, nq, nb, n, w, dtype):
    """K4's kim entry on its short and long-row paths, under both grids
    and every schedule that fits: lb1, lb and the stage bit-equal to K6's
    plain LB_Kim, then K2 + K3; LB_Kim prunes some pairs, pass 2 runs on
    others; and K4 without the entry keeps its bits."""
    cands, qs = walks(dev, 90, nb, n, dtype), walks(dev, 91, nq, n, dtype)
    cands[::2] += 100.0 * n  # far at their ends and extrema: LB_Kim prunes them
    u, l = envelopes(qs, w)
    lb1 = kk.lb_keogh_plain(cands, u, l, p)[0]
    # most of the near candidates reach pass 2
    top = torch.stack([torch.quantile(lb1[:, 1::2], 0.75, dim=1)] * 2, dim=1).contiguous()
    bounds = top[:, -1]  # stride 2
    real = nb - 1
    want = kim_reference(cands, qs, u, l, w, bounds, p, real)
    assert bool((want[2] == 0).any()) and bool(((want[2] >= 2) & (want[2] < 255)).any())
    plain = fused_reference(cands, qs, u, l, w, bounds, p)
    long = kf.fused_long(n, w, "qb", cands.element_size())
    schedules = [(None, None)] + [(cfg.tile_b, cfg.grid) for cfg in search_space("lb_fused")
                                  if long or kf.fused_smem_bytes(
                                      n, w, cfg.tile_b, cfg.grid,
                                      cands.element_size()) <= 232_448]
    for tile_b, grid in schedules:
        depth = None if tile_b is None else 1
        got = kf.lb_fused_launch(cands, qs, u, l, w, bounds, p, tile_b, depth, grid,
                                 stage=True, real=real, kim=True)
        assert all(torch.equal(g, e) for g, e in zip(got, want)), (tile_b, grid)
        got = kf.lb_fused_launch(cands, qs, u, l, w, bounds, p, tile_b, depth, grid,
                                 stage=True, real=real)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
        assert torch.equal(got[2], kf.lb_fused_stage_plain(*plain, bounds, real))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [0, 7, 40, 600])
def test_dtw_masked_kernel(dev, p, dtype, w):
    """Live slots of the masked entry (with its merge) bit-equal to the
    pair-list entry (bounds from a strided column); dead slots are not
    written, and rows read by no live slot may hold NaN."""
    n = 640 if w == 600 else 96
    rng = np.random.default_rng(44)
    qs, cands = walks(dev, 45, 5, n, dtype), walks(dev, 46, 12, n, dtype)
    stage = torch.as_tensor(rng.choice(np.array([0, 1, 2, 255], np.uint8), size=(5, 12)),
                            device=dev)
    stage[:, 3] = 0  # candidate 3 is read by no slot
    cands[3] = math.nan
    qi, ci = (t.contiguous() for t in (stage == 2).nonzero(as_tuple=True))
    exact = kd.dtw_launch(qs, cands, w, p, qi, ci)
    top = torch.full((5, 2), 1e30, dtype=dtype, device=dev)
    top[:, 1] = exact.median() if exact.numel() else 1e30
    for bounds in (None, top[:, 1]):
        out = torch.full((5, 12), math.nan, dtype=dtype, device=dev)
        merge = (torch.full((5, 1), 1e30, dtype=dtype, device=dev),
                 torch.full((5, 1), -1, dtype=torch.int64, device=dev),
                 torch.zeros((3, 5), dtype=torch.int64, device=dev),
                 torch.zeros(4, dtype=torch.int64, device=dev))
        got = kd.dtw_merge_launch(qs, cands, stage, w, p, bounds, out, *merge, 0, 16)
        b = None if bounds is None else bounds[qi].contiguous()
        assert torch.equal(got[qi, ci], kd.dtw_launch(qs, cands, w, p, qi, ci, b))
        assert bool(got[stage != 2].isnan().all())


def merge_inputs(dev, seed, nq, k, nb, dtype, n_lb=2):
    """Stages s < n_lb pruned by LB stage s, n_lb a survivor, 255 a pad."""
    rng = np.random.default_rng(seed)
    top_v = torch.as_tensor(np.sort(rng.integers(0, 4, (nq, k)) * 0.5, axis=1),
                            dtype=dtype, device=dev)
    top_v[0] = 1e30  # one query with an empty top-k
    top_i = torch.as_tensor(rng.integers(0, 1000, (nq, k)), device=dev)
    codes = np.array([*range(n_lb), n_lb, n_lb, 255], np.uint8)
    stage = torch.as_tensor(rng.choice(codes, size=(nq, nb)), device=dev)
    dvals = torch.as_tensor(rng.integers(0, 5, (nq, nb)) * 0.5, dtype=dtype, device=dev)
    dvals[stage != n_lb] = math.nan
    counts = torch.as_tensor(rng.integers(0, 9, (n_lb + 1, nq)), device=dev)
    totals = torch.as_tensor(rng.integers(0, 9, 4), device=dev)
    return top_v, top_i, counts, totals, stage, dvals


@pytest.mark.parametrize("nq", [1, 16, 40])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_merge_kernel_bit_equal(dev, nq, k, dtype):
    """Values from a few levels tie with each other and with the top-k;
    three blocks in a row; 40 queries loop over 32 warps."""
    got = merge_inputs(dev, 47 + nq + k, nq, k, 37, dtype)
    want = tuple(t.clone() for t in got)
    for lo in (0, 37, 74):
        kb.block_merge_launch(*got[:4], got[4], got[5], lo, 5)
        kb.block_merge_plain(*want[:4], want[4], want[5], lo, 5)
    for g, w_ in zip(got[:4], want[:4]):
        assert torch.equal(g, w_)


def merge_blocks(dev, seed, nq, nb, n, dtype, n_lb=2):
    """Four blocks of candidates and stages (survivors at n_lb): random
    stages, an all-dead block, a ragged tail (pad slots 255); rows repeat
    within and across blocks and queries are database rows, so DP values
    tie with each other and with entries already in the top-k."""
    rng = np.random.default_rng(seed)
    base = walks(dev, seed, 6, n, dtype)
    qs = base[rng.integers(0, 6, nq)].contiguous()
    blocks = []
    for t in range(4):
        cands = base[rng.integers(0, 6, nb)].contiguous()
        stage = rng.choice(np.array([*range(n_lb), n_lb, n_lb], np.uint8), size=(nq, nb))
        if t == 1:
            stage = rng.choice(np.arange(n_lb, dtype=np.uint8), size=(nq, nb))
        if t == 3:
            stage[:, nb - 5:] = 255
        blocks.append((t * nb, cands, torch.as_tensor(stage, device=dev)))
    return qs, blocks


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("nq", [1, 16, 33])
def test_dtw_merge_epilogue_bit_equal(dev, nq, k, dtype, p, bounded):
    """K5's masked entry with the merge against dtw_masked_plain (the
    kernel's wavefront DP) then block_merge_plain, block after block with
    bounds read from the top-k being merged: top-k values and indices,
    counts and totals bit-equal, the DP slots too."""
    nb, n, w = 37, 48, 5
    qs, blocks = merge_blocks(dev, 60 + nq + k, nq, nb, n, dtype)
    state = [torch.full((nq, k), 1e30, dtype=dtype, device=dev),
             torch.full((nq, k), -1, dtype=torch.int64, device=dev),
             torch.zeros((3, nq), dtype=torch.int64, device=dev),
             torch.zeros(4, dtype=torch.int64, device=dev)]
    want = [t.clone() for t in state]
    out = torch.full((nq, nb), math.nan, dtype=dtype, device=dev)
    out_want = out.clone()
    st = torch.empty((nq, nb), dtype=torch.uint8, device=dev)  # K4's stage buffer
    run = kd.dtw_masked_prepare(qs, w, p, st, state[0][:, -1] if bounded else None, out,
                                merge=(*state, 16))
    for lo, cands, stage in blocks:
        st.copy_(stage)
        run(cands, lo)
        kd.dtw_merge_plain(qs, cands, stage, w, p, want[0][:, -1] if bounded else None,
                           out_want, *want, lo, 16, dp=kd.dtw_wavefront_plain)
        live = stage == 2
        assert torch.equal(out[live], out_want[live])
        for g, w_ in zip(state, want):
            assert torch.equal(g, w_)
    assert int(state[2][2].sum()) > 0 and int(state[3][1]) > 0


@pytest.mark.parametrize("kim", [False, True])
@pytest.mark.parametrize("early_abandon", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_fused_block_loop_on_device_without_sync(dev, p, early_abandon, kim):
    """The loop launches K4 and K5 with the merge once per block and never
    synchronises (with ``kim``, one feature launch of K6 before it); its
    answers and counters equal the CPU loop's.  Some rows lie far off, so
    LB_Kim prunes pairs."""
    from repro_torch.core.cascade import fused_block_loop, nn_search_host

    rng = np.random.default_rng(48)
    x = rng.normal(size=(530, 96)).cumsum(axis=1).astype(np.float32)
    x[100:200] += 1.0e4
    q = rng.normal(size=(6, 96)).cumsum(axis=1).astype(np.float32)
    db, qs = torch.as_tensor(x, device=dev), torch.as_tensor(q, device=dev)
    u, l = envelopes(qs, 9)
    fused_block_loop(qs, db, u, l, 9, p, 3, 64, 16, early_abandon, kim)  # build, load
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fused_block_loop(qs, db, u, l, 9, p, 3, 64, 16, early_abandon, kim)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = launch_counts()
    blocks = -(-530 // 64)
    assert counts["lb_fused"] == counts["dtw_merge"] == blocks, counts
    assert counts["dtw"] == counts["block_merge"] == counts["lb_kim"] == 0, counts
    assert counts["lb_kim_features"] == int(kim), counts
    cpu = fused_block_loop(qs.cpu(), db.cpu(), u.cpu(), l.cpu(), 9, p, 3, 64, 16,
                           early_abandon, kim)
    assert torch.equal(out[1].cpu(), cpu[1])
    torch.testing.assert_close(out[0].cpu(), cpu[0], rtol=2e-4, atol=0)
    assert torch.equal(out[2].cpu(), cpu[2]) and torch.equal(out[3].cpu(), cpu[3])
    if kim:
        assert int(out[2][0].sum()) > 0  # pruned by LB_Kim
    method = "kim_improved" if kim else "lb_improved"
    got = nn_search_host(q, x, 9, p, 3, 64, method=method, early_abandon=early_abandon,
                         device=dev)
    np.testing.assert_array_equal(got.indices, out[1].cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("nq", [1, 16, 33])
def test_merge_with_lb_kim_first_bit_equal(dev, nq, k, dtype):
    """``kim_improved``'s three LB stages (counts (4, Q), survivors at
    stage 3): the standalone merge kernel and K5's masked entry with the
    merge bit-equal to their plain versions, block after block."""
    got = merge_inputs(dev, 80 + nq + k, nq, k, 37, dtype, n_lb=3)
    want = tuple(t.clone() for t in got)
    for lo in (0, 37, 74):
        kb.block_merge_launch(*got[:4], got[4], got[5], lo, 5)
        kb.block_merge_plain(*want[:4], want[4], want[5], lo, 5)
    assert all(torch.equal(g, w_) for g, w_ in zip(got[:4], want[:4]))
    nb, n, w = 37, 48, 5
    qs, blocks = merge_blocks(dev, 85 + nq + k, nq, nb, n, dtype, n_lb=3)
    state = [torch.full((nq, k), 1e30, dtype=dtype, device=dev),
             torch.full((nq, k), -1, dtype=torch.int64, device=dev),
             torch.zeros((4, nq), dtype=torch.int64, device=dev),
             torch.zeros(4, dtype=torch.int64, device=dev)]
    want = [t.clone() for t in state]
    out = torch.full((nq, nb), math.nan, dtype=dtype, device=dev)
    out_want = out.clone()
    st = torch.empty((nq, nb), dtype=torch.uint8, device=dev)
    run = kd.dtw_masked_prepare(qs, w, 1, st, state[0][:, -1], out, merge=(*state, 16))
    for lo, cands, stage in blocks:
        st.copy_(stage)
        run(cands, lo)
        kd.dtw_merge_plain(qs, cands, stage, w, 1, want[0][:, -1], out_want, *want, lo, 16,
                           dp=kd.dtw_wavefront_plain)
        live = stage == 3
        assert torch.equal(out[live], out_want[live])
        assert all(torch.equal(g, w_) for g, w_ in zip(state, want))
    assert int(state[2][3].sum()) > 0 and int(state[3][1]) > 0


# ------------------------------------------------------------------ long rows
#
# Past every kernel's shared-memory form: K1, K3, K4 and K5 take their
# long-row paths by shape (the buffers, or K5's rows and diagonals, in
# device memory), K2, K6 and K7 hold no row in shared memory.  Run with
# ``python -m pytest -q -m cuda tests/test_torch_cuda.py -k long``.

#: (n, dtype) of the long-row checks
LONG_ROWS = [(12_288, torch.float32), (6_144, torch.float64)]
BANDS = ["n//10", "n-1"]


def long_band(n, band):
    return n // 10 if band == "n//10" else n - 1


def pass2_in_block_order(h, qs, w, p):
    """K3's lb2 by its stated sum order, for p = 1 or inf (no multiply, so
    no contraction): element i's term goes to virtual thread i % 256 of a
    256-thread block in increasing i, each warp of eight is reduced by the
    xor butterfly and the eight partials are combined in order."""
    hu, hl = ke.envelope_plain(h, w)
    d = (qs - hu).clamp(min=0) + (hl - qs).clamp(min=0)
    rows, n = d.shape
    d = torch.cat([d, d.new_zeros(rows, -n % 256)], dim=1).reshape(rows, -1, 256)
    comb = torch.maximum if p == math.inf else torch.add
    acc = d.new_zeros(rows, 256)
    for k in range(d.shape[1]):
        acc = comb(acc, d[:, k])
    acc = acc.reshape(rows, 8, 32)
    lanes = torch.arange(32, device=h.device)
    for off in (16, 8, 4, 2, 1):
        acc = comb(acc, acc[:, :, lanes ^ off])
    r = acc[:, 0, 0]
    for j in range(1, 8):
        r = comb(r, acc[:, j, 0])
    return r


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("n,dtype", LONG_ROWS)
def test_long_rows_envelope_kernel(dev, n, dtype, band):
    """K1 bit-equal at long rows: 3 rows (a block per row where its padded
    row fits, else a warp per row) and 300 (a warp per row; its buffers in
    the workspace at w = n - 1)."""
    w = long_band(n, band)
    for rows in (3, 300):
        x = walks(dev, 60, rows + 1, n, dtype)[1:]  # a base off 16-byte alignment
        u, l = ke.envelope_launch(x, w)
        pu, pl = ke.envelope_plain(x, w)
        assert torch.equal(u, pu) and torch.equal(l, pl), rows


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("n,dtype", LONG_ROWS)
def test_long_rows_lb_keogh_and_pass2_kernels(dev, n, dtype, band):
    """K2 (H bit-equal, lb rtol 1e-4) and K3 at long rows: K3 bit-equal to
    its stated sum order at p = 1 and inf, within 2e-4 of the plain
    version at every p, dense and with pair lists."""
    w = long_band(n, band)
    cands, qs = walks(dev, 61, 5, n, dtype), walks(dev, 62, 2, n, dtype)
    u, l = envelopes(qs, w)
    for p in PS:
        lb, h = kk.lb_keogh_launch(cands, u, l, p)
        plb, ph = kk.lb_keogh_plain(cands, u, l, p)
        torch.testing.assert_close(lb, plb, rtol=1e-4, atol=0)
        assert torch.equal(h, ph)
        got = ki.lb_improved_pass2_launch(h, qs, w, p)
        torch.testing.assert_close(got, ki.lb_improved_pass2_plain(h, qs, w, p),
                                   rtol=2e-4, atol=0)
        if p != 2:
            qrows = qs[:, None, :].expand_as(h).reshape(-1, n)
            want = pass2_in_block_order(h.reshape(-1, n), qrows, w, p).reshape(got.shape)
            assert torch.equal(got, want)
        qi = torch.tensor([1, 0, 1], device=dev)
        rows = h.reshape(-1, n)[torch.tensor([9, 0, 5], device=dev)].contiguous()
        assert torch.equal(ki.lb_improved_pass2_launch(rows, qs, w, p, qi),
                           got.reshape(-1)[torch.tensor([9, 0, 5], device=dev)])


@pytest.mark.parametrize("p", [1, math.inf])
@pytest.mark.parametrize("nq,nb,n,w", [(16, 32, 1000, 100), (3, 7, 257, 0), (2, 5, 300, 299)])
def test_lb_improved_pass2_kernel_sum_order(dev, p, nq, nb, n, w):
    """K3 (shared-memory form) bit-equal to its stated sum order."""
    h = walks(dev, 63, nq * nb, n).reshape(nq, nb, n)
    qs = walks(dev, 64, nq, n)
    got = ki.lb_improved_pass2_launch(h, qs, w, p)
    qrows = qs[:, None, :].expand_as(h).reshape(-1, n)
    assert torch.equal(got.reshape(-1), pass2_in_block_order(h.reshape(-1, n), qrows, w, p))


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("n,dtype", LONG_ROWS)
def test_long_rows_lb_fused_workspace(dev, n, dtype, band):
    """K4 on its long-row path (H and pass 2's buffers in the prepared
    launcher's workspace, pass 2 K3's routine): bit-equal to K2 + K3 with
    the stage, at several tiles and both grids."""
    w = long_band(n, band)
    cands, qs = walks(dev, 65, 9, n, dtype), walks(dev, 66, 3, n, dtype)
    u, l = envelopes(qs, w)
    assert kf.fused_long(n, w, "qb", cands.element_size())
    for p in (1, 2):
        lb1 = kk.lb_keogh_plain(cands, u, l, p)[0]
        top = torch.stack([lb1.median(dim=1).values] * 2, dim=1).contiguous()
        top[0] = 0.0  # query 0: no live lane
        bounds = top[:, -1]
        want = fused_reference(cands, qs, u, l, w, bounds, p)
        real = 7
        stage_want = kf.lb_fused_stage_plain(*want, bounds, real)
        for tile_b, grid in ((None, None), (1, "qb"), (8, "qb"), (3, "bq")):
            got = kf.lb_fused_launch(cands, qs, u, l, w, bounds, p, tile_b,
                                     None if tile_b is None else 1, grid, stage=True,
                                     real=real)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), tile_b
            assert torch.equal(got[2], stage_want), tile_b


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("n,dtype", LONG_ROWS)
def test_long_rows_lb_kim_and_stream_kernels(dev, n, dtype, band):
    """K6 bit-equal at long rows, at every tile, on rows as allocated and
    on the same buffer viewed one value further on (no row start 16-byte
    aligned: the scalar path), and K7 (windows at an odd hop, so not
    16-byte aligned) bit-equal to K2 on the copied windows."""
    w = long_band(n, band)
    rows = walks(dev, 67, 9, n, dtype)
    shifted = rows.reshape(-1)[1:1 + 8 * n].view(8, n)
    mask = torch.tensor([[1, 0, 1, 1, 0, 1], [0, 1, 1, 1, 1, 0]], device=dev).bool()
    for src in (rows, shifted):
        cands, qs = src[:6], src[6:8]
        for p in PS:
            want = km.lb_kim_plain(cands, qs, mask, p)
            assert torch.equal(km.lb_kim_launch(cands, qs, mask, p), want)
            for cfg in search_space("lb_kim"):
                assert torch.equal(km.lb_kim_launch(cands, qs, mask, p, cfg.tile_b), want), cfg
        assert torch.equal(km.lb_kim_features_launch(src), km.lb_kim_features_plain(src))
    qs = rows[6:8]
    seg = walks(dev, 69, 1, 5 * 3 + n, dtype)[0]
    u, l = envelopes(qs, w)
    for p in PS:
        lb, h = kk.lb_keogh_stream_launch(seg, u, l, n, 3, p)
        klb, kh = kk.lb_keogh_launch(kk.materialize_windows(seg, n, 3), u, l, p)
        assert torch.equal(lb, klb) and torch.equal(h, kh)


@pytest.mark.parametrize("n,w,dtype", [
    (12_288, 12_287, torch.float32), (6_144, 6_143, torch.float64),  # rows in place
    (32_768, 500, torch.float32),  # past the register path's two staged rows
    (16_000, 15_999, torch.float64),  # the diagonals in the workspace too
])
def test_long_rows_dtw_kernel(dev, n, w, dtype):
    """K5's long-row path bit-equal to its wavefront plain version, full
    and with one lane abandoned; the masked entry with the merge takes the
    same path, bit-equal to dtw_masked_plain then block_merge_plain."""
    qs, cands = walks(dev, 70, 2, n, dtype), walks(dev, 71, 2, n, dtype)
    qi, ci = torch.tensor([0, 1], device=dev), torch.tensor([1, 0], device=dev)
    want = kd.dtw_wavefront_plain(qs, cands, w, 1, qi, ci)
    assert torch.equal(kd.dtw_launch(qs, cands, w, 1, qi, ci), want)
    bounds = torch.stack([want[0] * 2, want[1] * 0.5]).contiguous()
    assert torch.equal(kd.dtw_launch(qs, cands, w, 1, qi, ci, bounds),
                       kd.dtw_wavefront_plain(qs, cands, w, 1, qi, ci, bounds))
    stage = torch.tensor([[0, 2], [2, 1]], dtype=torch.uint8, device=dev)
    state = [torch.full((2, 1), 1e30, dtype=dtype, device=dev),
             torch.full((2, 1), -1, dtype=torch.int64, device=dev),
             torch.zeros((3, 2), dtype=torch.int64, device=dev),
             torch.zeros(4, dtype=torch.int64, device=dev)]
    expect = [t.clone() for t in state]
    out = torch.full((2, 2), math.nan, dtype=dtype, device=dev)
    out_want = out.clone()
    kd.dtw_merge_launch(qs, cands, stage, w, 1, None, out, *state, 0, 16)
    kd.dtw_merge_plain(qs, cands, stage, w, 1, None, out_want, *expect, 0, 16,
                       dp=kd.dtw_wavefront_plain)
    live = stage == 2
    assert torch.equal(out[live], out_want[live])
    assert all(torch.equal(g, e) for g, e in zip(state, expect))


def test_long_rows_fused_block_loop_without_sync(dev):
    """The host driver's device loop at rows whose K4 takes its long-row
    path (float64, n = 5,200): two launches per block, no
    synchronisation, the CPU loop's answers and counters."""
    from repro_torch.core.cascade import fused_block_loop

    n, w = 5200, 520
    db, qs = walks(dev, 72, 40, n, torch.float64), walks(dev, 73, 2, n, torch.float64)
    assert kf.fused_long(n, w, "qb", 8) and not kf.fused_long(4900, w, "qb", 8)
    u, l = envelopes(qs, w)
    fused_block_loop(qs, db, u, l, w, 1, 2, 16, 16)  # build, load
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fused_block_loop(qs, db, u, l, w, 1, 2, 16, 16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = launch_counts()
    assert counts["lb_fused"] == counts["dtw_merge"] == 3, counts
    cpu = fused_block_loop(qs.cpu(), db.cpu(), u.cpu(), l.cpu(), w, 1, 2, 16, 16)
    assert torch.equal(out[1].cpu(), cpu[1])
    torch.testing.assert_close(out[0].cpu(), cpu[0], rtol=1e-12, atol=0)
    assert torch.equal(out[2].cpu(), cpu[2]) and torch.equal(out[3].cpu(), cpu[3])


# ------------------------------------------- K5's channel entry (d > 1)


def mv_rows(dev, seed, rows, n, d, dtype=torch.float32):
    """(rows, d*n) channel-major flattened random walks, one per channel."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d, n)).cumsum(axis=2).reshape(rows, d * n)
    return torch.as_tensor(x, dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,n,w", [(3, 315, 31), (8, 315, 31), (2, 17, 16), (3, 40, 0)])
@pytest.mark.parametrize("p", PS)
def test_dtw_channel_entry_bit_equal_wavefront(dev, p, d, n, w, dtype):
    """K5's channel entry (the cell cost summed over d channels, the max at
    p = inf) is bit-equal to ``dtw_wavefront_plain(d=)`` on every lane,
    dense and pair list, finished or abandoned, including a band that
    reaches the grid's edge (w = n - 1); finished lanes are within 3e-4 of
    the reference's row DP (``dtw_plain(d=)``)."""
    qs, cs = mv_rows(dev, 60, 3, n, d, dtype), mv_rows(dev, 61, 9, n, d, dtype)
    got = kd.dtw_launch(qs, cs, w, p, d=d)
    assert torch.equal(got, kd.dtw_wavefront_plain(qs, cs, w, p, d=d))
    torch.testing.assert_close(got, kd.dtw_plain(qs, cs, w, p, d=d), rtol=3e-4, atol=0)
    qi = torch.tensor([0, 2, 1, 1, 0], device=dev)
    ci = torch.tensor([8, 0, 4, 3, 3], device=dev)
    exact = got[qi, ci]
    bounds = (exact * torch.tensor([0.2, 0.9, 1.5, 0.5, 2.0], device=dev, dtype=dtype))
    ab = kd.dtw_launch(qs, cs, w, p, qi, ci, bounds.contiguous(), d=d)
    assert torch.equal(ab, kd.dtw_wavefront_plain(qs, cs, w, p, qi, ci, bounds, d=d))
    below = exact < bounds
    assert torch.equal(ab[below], exact[below]) and bool((ab[~below] >= bounds[~below]).all())


@pytest.mark.parametrize("p", PS)
def test_dtw_channel_entry_in_place_path(dev, p):
    """Where 2 d staged segments overflow a block's shared memory the
    channel entry reads the rows in place (path -3), bit-equal still."""
    from repro_torch.kernels import cuda_lib

    d, n, w = 8, 4000, 40
    assert cuda_lib.library().repro_dtw_slots(0, n, w, d) == -3
    assert cuda_lib.library().repro_dtw_slots(0, 315, 31, 3) == -2
    qs, cs = mv_rows(dev, 62, 1, n, d), mv_rows(dev, 63, 2, n, d)
    assert torch.equal(kd.dtw_launch(qs, cs, w, p, d=d),
                       kd.dtw_wavefront_plain(qs, cs, w, p, d=d))


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("d", [3, 8])
@pytest.mark.parametrize("p", PS)
def test_dtw_channel_entry_masked_with_merge(dev, p, d, bounded):
    """The masked channel entry with the merge: bit-equal to
    ``dtw_merge_plain(dp=dtw_wavefront_plain, d=)``, launches counted as
    ``dtw_merge_mv``."""
    nq, nb, n, w = 16, 32, 64, 6
    qs, cs = mv_rows(dev, 64, nq, n, d), mv_rows(dev, 65, nb, n, d)
    rng = np.random.default_rng(66)
    stage = torch.as_tensor(rng.choice(np.array([0, 1, 2, 2], np.uint8), (nq, nb)),
                            device=dev)

    def state():
        return (torch.full((nq, 2), 1e30, device=dev),
                torch.full((nq, 2), -1, dtype=torch.int64, device=dev),
                torch.zeros((3, nq), dtype=torch.int64, device=dev),
                torch.zeros(4, dtype=torch.int64, device=dev))

    got, want = state(), state()
    out, out_w = (torch.full((nq, nb), math.nan, device=dev) for _ in range(2))
    reset_launch_counts()
    run = kd.dtw_masked_prepare(qs, w, p, stage, got[0][:, -1] if bounded else None, out,
                                (*got, 16), d=d)
    for t in range(2):
        run(cs, t * nb)
        kd.dtw_merge_plain(qs, cs, stage, w, p, want[0][:, -1] if bounded else None, out_w,
                           *want, t * nb, 16, dp=kd.dtw_wavefront_plain, d=d)
        live = stage == 2
        assert torch.equal(out[live], out_w[live])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    counts = launch_counts()
    assert counts["dtw_merge_mv"] == 2 and counts["dtw_merge"] == 0, counts


@pytest.mark.parametrize("early_abandon", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_mv_device_loop_without_sync(dev, p, early_abandon):
    """At d = 3 the device loop composes its K4 step (K2, the folded K3,
    tensor operations for pass 2's `where` and the stages), then K5's
    masked channel entry with the merge, per block, with no
    synchronisation; the answers and counters equal the CPU loop's."""
    from repro_torch.core.cascade import fused_block_loop

    d, n = 3, 48
    x = mv_rows(dev, 67, 300, n, d)
    qs = mv_rows(dev, 68, 5, n, d)
    u, l = ke.envelope_op(qs, 5, d)
    fused_block_loop(qs, x, u, l, 5, p, 3, 32, 16, early_abandon, d=d)  # build, load
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fused_block_loop(qs, x, u, l, 5, p, 3, 32, 16, early_abandon, d=d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = launch_counts()
    blocks = -(-300 // 32)
    assert counts["lb_keogh"] == counts["lb_improved_pass2"] == blocks, counts
    assert counts["dtw_merge_mv"] == blocks and counts["lb_fused"] == 0, counts
    cpu = fused_block_loop(qs.cpu(), x.cpu(), u.cpu(), l.cpu(), 5, p, 3, 32, 16,
                           early_abandon, d=d)
    assert torch.equal(out[1].cpu(), cpu[1])
    torch.testing.assert_close(out[0].cpu(), cpu[0], rtol=2e-4, atol=0)
    assert torch.equal(out[2].cpu(), cpu[2]) and torch.equal(out[3].cpu(), cpu[3])


def test_mv_session_every_method_on_card(dev):
    """A (N, n, 3) session on the card answers as on the CPU through every
    method and driver, and launches the channel entries."""
    rng = np.random.default_rng(69)
    x = rng.normal(size=(200, 40, 3)).cumsum(axis=1).astype(np.float32)
    q = rng.normal(size=(4, 40, 3)).cumsum(axis=1).astype(np.float32)
    cfg = SearchConfig(k=3, block=16)
    gpu = Database.build(x, cfg, index=True, n_refs=4, device=dev)
    cpu = Database.build(x, cfg, index=True, n_refs=4, device="cpu")
    reset_launch_counts()
    for method in ("full", "lb_keogh", "lb_improved", "lb_webb", "kim_improved", "kim_webb",
                   "tc_box", "tc_tri", "auto"):
        for driver in ("scan", "host", "indexed"):
            a = gpu.search(q, method=method, driver=driver)
            b = cpu.search(q, method=method, driver=driver)
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_allclose(a.distances, b.distances, rtol=2e-4)
    counts = launch_counts()
    assert counts["dtw_mv"] > 0 and counts["dtw_merge_mv"] > 0, counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("d,n,hop", [(2, 37, 1), (3, 128, 4), (8, 37, 4), (3, 1000, 1)])
def test_lb_keogh_stream_channels(dev, d, n, hop, p, dtype):
    """K7c reads window b's flat row out of the (d, L) segment in place:
    lb and H bit-equal to K2 on the gathered tile, at every tile_b; H
    bit-equal to its plain version and lb within 1e-4 (bit-equal at p =
    inf, where no sum is taken); counted as lb_keogh_stream_mv, not K7."""
    nb = 37
    seg = mv_rows(dev, 70 + d, d, (nb - 1) * hop + n + 1, 1, dtype).reshape(d, -1)
    qs = mv_rows(dev, 71, 3, n, d, dtype)
    u, l = ke.envelope_op(qs, max(1, n // 10), d)
    reset_launch_counts()
    lb, h = kk.lb_keogh_stream_launch(seg, u, l, n, hop, p, d=d)
    counts = launch_counts()
    assert (counts["lb_keogh_stream_mv"], counts["lb_keogh_stream"]) == (1, 0), counts
    plb, ph = kk.lb_keogh_stream_plain(seg, u, l, n, hop, p, d=d)
    torch.testing.assert_close(lb, plb, rtol=1e-4, atol=0)
    assert torch.equal(h, ph) and (p != math.inf or torch.equal(lb, plb))
    nb_exp = (seg.shape[1] - n) // hop + 1  # the segment holds nb + 1 windows at hop 1
    assert lb.shape == (3, nb_exp) and h.shape == (3, nb_exp, d * n)
    tile = kk.stream_tile(seg, n, hop, d).contiguous()
    assert tile.shape == (nb_exp, d * n)
    klb, kh = kk.lb_keogh_launch(tile, u, l, p)
    assert torch.equal(lb, klb) and torch.equal(h, kh)
    for cfg in search_space("lb_keogh"):
        got = kk.lb_keogh_stream_launch(seg, u, l, n, hop, p, cfg.tile_b, d=d)
        assert torch.equal(got[0], lb) and torch.equal(got[1], h), cfg


@pytest.mark.parametrize("znorm", [False, True])
def test_mv_stream_scanner_on_card(dev, znorm):
    """A d = 3 stream matcher on the card gives the CPU matcher's matches
    (the same pairs; distances within rtol 3e-4, K5 against the CPU's row
    DP) and counters; without znorm S1 is K7c once a block, with it K2's
    dense stage and no K7c."""
    from repro_torch.stream import StreamMatcher

    rng = np.random.default_rng(72)
    d, n = 3, 32
    stream = np.cumsum(rng.normal(size=(2000, d)), axis=0).astype(np.float32)
    templates = np.stack([stream[400 : 400 + n], stream[1200 : 1200 + n]])
    out = {}
    for device in (dev, "cpu"):
        m = StreamMatcher(templates, 4, 3.0, p=2, hop=2, znorm=znorm, block=16, d=d,
                          device=device)
        reset_launch_counts()
        for lo in range(0, stream.shape[0], 333):
            m.push(stream[lo : lo + 333])
        m.flush()
        out[str(device)] = (m.matches(), m.stats, launch_counts())
    (g, gs, gc), (c, cs, _) = out[str(dev)], out["cpu"]
    assert [(h.tid, h.start) for h in g] == [(h.tid, h.start) for h in c]
    np.testing.assert_allclose([h.dist for h in g], [h.dist for h in c], rtol=3e-4)
    assert {(0, 400), (1, 1200)} <= {(h.tid, h.start) for h in g}
    for f in ("n_windows", "env_pruned", "stage_pruned", "full_dtw", "matched"):
        np.testing.assert_array_equal(getattr(gs, f), getattr(cs, f), err_msg=f)
    assert gc["lb_keogh_stream"] == 0, gc
    assert gc["lb_keogh_stream_mv"] == (0 if znorm else gs.blocks_total), gc


@pytest.mark.parametrize("p", PS)
def test_anytime_search_on_card(dev, p):
    """The anytime tier's search side on the card against the CPU route on
    the same tier (one set of bundle arrays): the same indices and
    counts, distances within rtol 2e-4, at every budget of a short ladder
    and on both lengths; the refinement launches K1, K2, K3 and K5 and no
    host-loop kernel; unlimited answers bit-match ``mode="exact"`` on the
    card (the host and scan drivers on the whole row, a K5 brute force
    over the bank for subsequence queries)."""
    from repro_torch.core.dtw import finish_cost

    rng = np.random.default_rng(73)
    x = rng.normal(size=(300, 96)).cumsum(axis=1).astype(np.float32)
    gpu = Database.build(x, SearchConfig(k=3, p=p), anytime=dict(lengths=(48, 96), hop=8,
                                                                  leaf_size=16), device=dev)
    cpu = Database.from_arrays(gpu.to_arrays(), device="cpu")
    for m in (48, 96):
        qs = rng.normal(size=(3, m)).cumsum(axis=1).astype(np.float32)
        for budget in (gpu.anytime.tier(m).tree.n_coarse, 200, None):
            reset_launch_counts()
            a = gpu.search(qs, mode="anytime", budget=budget)
            counts = launch_counts()
            b = cpu.search(qs, mode="anytime", budget=budget)
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_allclose(a.distances, b.distances, rtol=2e-4)
            assert (a.error_bounds == 0).tolist() == (b.error_bounds == 0).tolist()
            for f in ("refined", "clusters_explored", "nodes_expanded", "frontier",
                      "full_dtw", "stage_pruned"):
                assert getattr(a.stats, f) == getattr(b.stats, f), f
            for name in ("envelope", "lb_keogh", "lb_improved_pass2", "dtw"):
                assert counts[name] > 0, counts
            assert counts["lb_fused"] == counts["dtw_merge"] == 0, counts
        assert (a.error_bounds == 0).all()
        if m == 96:
            for driver in ("host", "scan"):
                want = gpu.search(qs, driver=driver)
                assert a.distances.tobytes() == want.distances.tobytes(), driver
                np.testing.assert_array_equal(a.indices, want.indices)
        else:
            exact = gpu.search(qs)
            assert exact.distances.tobytes() == a.distances.tobytes()
            li = gpu.anytime.tier(m)
            q = torch.as_tensor(gpu.prepare_queries(qs, length=m), device=dev)
            d = finish_cost(kd.dtw_qbatch_op(q, li.wins, li.w, p), p).cpu().numpy()
            for qi in range(3):
                order = np.lexsort((np.arange(d.shape[1]), d[qi]))[:3]
                np.testing.assert_array_equal(exact.indices[qi], order)
                assert exact.distances[qi].tobytes() == d[qi, order].tobytes()


@pytest.mark.parametrize("p", PS)
def test_anytime_serving_on_card(dev, p):
    """``QueryEngine.submit(mode="anytime")`` on the card: each answer,
    unlimited and at two budgets, at the whole length and a subsequence
    length, bit-equal to a direct ``db.search(mode="anytime", budget=)``
    on the card, bounds included; a resubmitted request is a cache hit
    with the same bounds; the requests launch K1, K2, K3 and K5 and no
    host-loop kernel."""
    from repro_torch.serve import QueryEngine

    rng = np.random.default_rng(79)
    x = rng.normal(size=(300, 96)).cumsum(axis=1).astype(np.float32)
    db = Database.build(x, SearchConfig(k=3, p=p), anytime=dict(lengths=(48, 96), hop=8,
                                                                 leaf_size=16), device=dev)
    requests = [(q, b) for m in (48, 96) for q in rng.normal(size=(2, m)).cumsum(axis=1)
                .astype(np.float32) for b in (None, db.anytime.tier(m).tree.n_coarse, 200)]
    with QueryEngine(db, max_batch=4, max_wait_ms=1.0) as engine:
        reset_launch_counts()
        answers = [engine.submit(q, mode="anytime", budget=b).result(timeout=120)
                   for q, b in requests]
        counts = launch_counts()
        q, b = requests[-1]
        hit = engine.submit(q, mode="anytime", budget=b).result(timeout=120)
        stats = engine.stats()
    for (q, b), a in zip(requests, answers):
        want = db.search(q, mode="anytime", budget=b)
        for f in ("indices", "distances", "error_bounds"):
            assert getattr(a, f).tobytes() == getattr(want, f).tobytes(), (f, b)
        assert a.stats.refined == want.stats.refined
    assert hit.cache_hit and hit.error_bounds.tobytes() == answers[-1].error_bounds.tobytes()
    for name in ("envelope", "lb_keogh", "lb_improved_pass2", "dtw"):
        assert counts[name] > 0, counts
    assert counts["lb_fused"] == counts["dtw_merge"] == 0, counts
    assert stats.anytime_served == len(requests) + 1
    assert stats.clusters_explored == sum(a.stats.clusters_explored for a in answers)
