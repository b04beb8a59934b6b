"""PyTorch/CUDA port of ``repro``: exact DTW nearest-neighbour search with
the two-pass LB_Improved cascade, on one NVIDIA H100.

The package mirrors ``repro``'s layout module for module.  Plain tensor
code is PyTorch; every kernel the reference wrote in Pallas for the TPU
is hand-written CUDA C++ in ``csrc/`` (envelope, LB_Keogh + projection
and its stream form, LB_Improved pass 2, the fused two-pass LB stage,
LB_Kim, banded DP), built with ``nvcc`` at first use.  Entry points run
on the GPU unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its plain PyTorch version.  ``kernels/tuning`` holds
the schedule table the wrappers resolve, and ``Database.build(tune=...)``
sweeps it.

The stage-0 index (``index``), streaming subsequence search
(``stream``), the multi-tenant serving engine (``serve``), the
multivariate tier (``mv``: dependent DTW on channel-major rows, every
driver and method, the TC-DTW stages, streaming and serving), the
sharded driver (``core.distributed``) and the anytime tier's build side
(``anytime``: window banks and cluster trees, radii by K5) are ported;
the anytime tier's search and serving, and an engine over a multi-rank
mesh, are queued in ROADMAP.md.
"""

from repro_torch.api import Database, SearchConfig

__all__ = ["Database", "SearchConfig"]
