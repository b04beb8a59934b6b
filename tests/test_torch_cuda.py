"""repro_torch's CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc: a CUDA kernel has no CPU build, so
every test here is marked ``cuda`` and skips with a reason elsewhere.
Run them on the card with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py`` (the file imports no JAX).  Tolerances:
envelope and H bit-equal, LB_Keogh rtol 1e-4, LB_Improved 2e-4, DP 3e-4.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.kernels import dtw as kd  # noqa: E402
from repro_torch.kernels import envelope as ke  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import lb_improved as ki  # noqa: E402
from repro_torch.kernels import lb_keogh as kk  # noqa: E402

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


def test_default_session_launches_every_kernel(dev):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1100, 96)).cumsum(axis=1).astype(np.float32)
    q = rng.normal(size=(4, 96)).cumsum(axis=1).astype(np.float32)
    reset_launch_counts()
    db = Database.build(x, SearchConfig(k=3))
    res = db.search(q)
    counts = launch_counts()
    assert all(v > 0 for v in counts.values()), counts
    ref = Database.build(x, SearchConfig(k=3), device="cpu").search(q)
    np.testing.assert_array_equal(res.indices, ref.indices)
    np.testing.assert_allclose(res.distances, ref.distances, rtol=2e-4)
