"""Warping envelope: the K1 CUDA kernel's wrapper and its plain version.

The kernel (``csrc/envelope.cu``) replaces the TPU kernel
``repro/kernels/envelope/kernel.py::envelope_pallas_padded``.  The op keeps
the reference op's semantics: w is clamped to n - 1 and w = 0 returns
(x, x) without a launch.  The kernel pads inside shared memory, so no
+-BIG padded copies are made here.  A batch of up to ``SMALL_ROWS`` rows
runs a block per row that reduces the row by doubling; a larger one runs
one warp per row and cuts the padded row into ``envelope_chunk(n, w)``
chunks (van Herk–Gil–Werman scans per chunk); the plain version cuts it
into tiles of 2w + 1.  Max and min are exact, so all give the same bits.
Where one warp's buffers overflow a block's shared memory (long rows),
the warp per row keeps them in a workspace that the launch allocates
(``cuda_lib.workspace``), so every length runs.  Multivariate rows
(``d > 1``) are enveloped per channel segment: the op folds the segments
into the batch, and the kernel is unchanged.
"""

from __future__ import annotations

import torch

from repro_torch.core.envelope import envelope_batch
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import check_cuda_tensor, count_launch, kernel_dtype


#: batches of up to this many rows run a block per row
#: (``csrc/envelope.cu`` ENV_SMALL_ROWS), unless 4 (n + 2w) values of the
#: padded row overflow a block's shared memory
SMALL_ROWS = 256


def envelope_chunk(n: int, w: int) -> int:
    """The chunk the warp per row cuts a padded row of n + 2w values into,
    for 1 <= w <= n - 1 (``csrc/envelope.cu`` env_chunk): about (n + 2w) /
    32, odd, at most 2w - 1, so every window of 2w + 1 values spans two
    chunks."""
    c = -(-(n + 2 * w) // 32) | 1
    return min(c, 2 * w - 1)


def envelope_plain(xs: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (van Herk–Gil–Werman)."""
    return envelope_batch(xs, w)


def envelope_launch(xs: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on a contiguous CUDA (rows, n) batch, 1 <= w <= n - 1."""
    rows, n = xs.shape
    check_cuda_tensor("xs", xs, xs.device, xs.dtype)
    u = torch.empty_like(xs)
    l = torch.empty_like(xs)
    ws = cuda_lib.workspace("envelope", xs.device, kernel_dtype(xs), rows, n, w)
    code = cuda_lib.library().repro_envelope(
        kernel_dtype(xs), xs.data_ptr(), u.data_ptr(), l.data_ptr(),
        rows, n, w, cuda_lib.ptr(ws), cuda_lib.stream_of(xs.device),
    )
    cuda_lib.check("envelope", code)
    if rows:
        count_launch(envelope_launch)
    return u, l


envelope_launch.launches = 0


def envelope_op(xs: torch.Tensor, w: int, d: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched warping envelope (U, L) of ``xs`` (..., n).

    ``d > 1`` takes channel-major flattened rows (..., d*n): each length-n
    channel segment is enveloped as its own series (w clamped to n - 1),
    the segments folded into the batch of one launch, as the reference's
    op folds them.  CUDA tensors go through the kernel (or raise); CPU
    tensors take the plain version."""
    d = int(d)
    if d > 1:
        total = xs.shape[-1]
        if total % d:
            raise ValueError(f"flat length {total} not a multiple of d={d}")
        u, l = envelope_op(xs.reshape(-1, total // d).contiguous(), w)
        return u.reshape(xs.shape), l.reshape(xs.shape)
    n = xs.shape[-1]
    w = int(min(w, n - 1))
    if w == 0:
        return xs, xs
    if xs.device.type == "cpu":
        return envelope_plain(xs, w)
    if xs.device.type != "cuda":
        raise ValueError(f"envelope_op runs on cuda or cpu, got {xs.device}")
    u, l = envelope_launch(xs.reshape(-1, n), w)
    return u.reshape(xs.shape), l.reshape(xs.shape)
