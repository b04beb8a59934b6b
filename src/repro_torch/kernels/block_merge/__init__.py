from repro_torch.kernels.block_merge.ops import (
    block_merge_launch,
    block_merge_plain,
    block_merge_prepare,
)

__all__ = [
    "block_merge_launch",
    "block_merge_plain",
    "block_merge_prepare",
]
