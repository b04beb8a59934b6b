"""Per-backend default schedules (port of ``repro.kernels.tuning.defaults``).

These are what a session resolves before any ``autotune`` has run.  Keys
are ``(family, backend, bucket)`` with ``"*"`` wildcards; the backend is
the device type, ``"cuda"`` or ``"cpu"``.  The ``"cuda"`` entries are the
schedules the kernels ran before tuning existed: 8 warps per block for
K2/K7 and K6, and 32-lane pipeline gathers.  K4 runs one warp per
(query, candidate) pair; its default is 8 warps per block, one block per
(query, tile of 8 candidates), ``grid="qb"``: at the host driver's shape
(16 queries, 32 candidates) that is 64 blocks of 8 warps, where ``"bq"``
would give 4, and each warp's H row and envelope buffers take 23 KB of
shared memory at n = 1000, w = 100 in float32 (186 KB a block).  Where
a resolved K4 tile does not fit in shared memory (long series), the
wrapper halves it until it does (``lb_fused/ops.py``).
On the CPU the plain versions have no schedule, so only
the pipeline's ``lane_chunk`` matters there.
"""

from __future__ import annotations

from repro_torch.kernels.tuning.space import KernelConfig

DEFAULT_ENTRIES: dict[tuple[str, str, str], KernelConfig] = {
    ("lb_keogh", "cuda", "*"): KernelConfig(tile_b=8),
    ("lb_kim", "cuda", "*"): KernelConfig(tile_b=8),
    ("lb_fused", "cuda", "*"): KernelConfig(tile_b=8, depth=1, grid="qb"),
    ("pipeline", "*", "*"): KernelConfig(lane_chunk=32),
}
