"""Shared constants and helpers of the CUDA kernels and their wrappers.

The sentinels are large but finite so float32 arithmetic never produces
inf/NaN inside the DP recurrences; the abandon test ``min(prev) < bound``
and the scan driver's pad-row filler (``0.5 * BIG ** 0.25``) rely on it.
"""

from __future__ import annotations

import math
import threading

import torch

# finite sentinel; |x - PAD|^2 must stay < fp32 max
PAD_VALUE = 1.0e15
BIG = 1.0e30

#: dtypes the CUDA kernels are instantiated for (code 0 and 1 in the C ABI)
KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}

#: shared memory one block may use on sm_90 (227 KB), static included
SMEM_LIMIT_BYTES = 232_448


class NotRunnable(ValueError):
    """A schedule that cannot launch at this shape (for example a tile
    whose shared memory exceeds the card's limit).  ``autotune`` records
    such a config as not runnable instead of raising."""


#: guards the launch counters: the serving engine's worker and its stream
#: clients launch from their own threads
_COUNT_LOCK = threading.Lock()


def count_launch(launch_fn) -> None:
    """Add one to the ``launches`` count of a kernel's launch function."""
    with _COUNT_LOCK:
        launch_fn.launches += 1


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    device of the tensor ``like``, else the GPU.  Never falls back to the
    CPU quietly: with no CUDA device the caller has to ask for it."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: repro_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")


def p_code(p) -> int:
    """The C ABI's norm code: 1, 2, or 0 for p = inf; other p raise."""
    if p == math.inf:
        return 0
    if p in (1, 2):
        return int(p)
    raise ValueError(f"the CUDA kernels serve p in {{1, 2, inf}}, got p={p!r}")


def check_cuda_tensor(name: str, t: torch.Tensor, device, dtype, shape=None):
    """Validate one kernel argument; raise rather than launch on it."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def warps_per_block(tile_b: int) -> int:
    """The ``tile_b`` of a one-warp-per-pair kernel: 1 to 32 warps."""
    tile_b = int(tile_b)
    if not 1 <= tile_b <= 32:
        raise NotRunnable(f"tile_b={tile_b} warps per block is outside 1..32")
    return tile_b


def kernel_dtype(t: torch.Tensor) -> int:
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"the CUDA kernels take float32 or float64 tensors, got {t.dtype}"
        )
    return KERNEL_DTYPES[t.dtype]
