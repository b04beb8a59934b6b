"""PyTorch/CUDA port of ``repro``: exact DTW nearest-neighbour search with
the two-pass LB_Improved cascade, on one NVIDIA H100.

The package mirrors ``repro``'s layout module for module.  Plain tensor
code is PyTorch; the four kernels under the default session's path
(envelope, LB_Keogh + projection, LB_Improved pass 2, banded DP) are
hand-written CUDA C++ in ``csrc/``, built with ``nvcc`` at first use.
Entry points run on the GPU unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.

This slice is univariate; the index, anytime, streaming, serving,
multivariate, sharded and tuning tiers are queued in ROADMAP.md.
"""

from repro_torch.api import Database, SearchConfig

__all__ = ["Database", "SearchConfig"]
