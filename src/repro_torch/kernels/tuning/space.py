"""Kernel schedule search spaces and shape buckets (port of
``repro.kernels.tuning.space``).

A :class:`KernelConfig` is one point in a kernel family's *schedule*
space.  The field names and their validation are the reference's, so a
``tune_json`` bundle is read by both packages; their meaning on Hopper:

* ``tile_b`` — for the one-warp-per-pair kernels (K2 ``lb_keogh``, its
  stream form K7, K6 ``lb_kim`` and K4 ``lb_fused``): warps, that is
  pairs, per block.
* ``grid`` — for K4: ``"qb"`` runs one block per (query, tile of
  candidates); ``"bq"`` runs one block per tile, each warp staging its
  candidate row in shared memory once and looping over the queries.
* ``depth`` — the reference's DMA double buffering.  The CUDA K4 has no
  ``cp.async`` pipeline (ROADMAP.md queue 2: its tile sits in L2 and the
  kernel is latency-bound), so its space sweeps ``depth=1`` only and the
  wrapper refuses ``depth=2``.
* ``lane_chunk`` — compacted survivor lanes per gather in
  ``repro_torch.core.pipeline``, as in the reference.

A family's space lists only the knobs its CUDA kernel honours and that
leave every per-pair reduction order unchanged: no config may change an
output bit, and ``autotune`` discards any that does.  K1 ``envelope`` and
K3 ``lb_improved`` choose their own warps per row from the batch and the
row length (K3 sums in the order of a 256-thread block, whatever its
launch), so their space is the fallback alone.  K5
``dtw`` runs one warp per pair with the band's slots per lane set by w
(a register or a shared-memory wavefront, the same bits either way), so
it has no schedule to sweep and its space is the fallback alone too.

Shape buckets are the reference's: the next powers of two of the
candidate-batch and series-length axes.
"""

from __future__ import annotations

import dataclasses

#: kernel families a TuneTable may hold entries for (the reference's)
FAMILIES = (
    "envelope",
    "lb_kim",
    "lb_keogh",
    "lb_improved",
    "lb_fused",
    "dtw",
    "pipeline",
)

#: grid layouts of K4: which axis a block covers
GRID_LAYOUTS = ("qb", "bq")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One schedule point.  Fields a family does not use are ignored by
    its op wrapper."""

    tile_b: int = 8  # warps, that is pairs, per block (K2, K4, K6, K7)
    lane_chunk: int = 32  # compacted lanes per pipeline gather
    depth: int = 1  # staging slots; the CUDA kernels run depth 1
    grid: str = "qb"  # K4: "qb" block per (query, tile); "bq" per tile

    def __post_init__(self):
        if self.tile_b < 1 or self.lane_chunk < 1:
            raise ValueError(f"non-positive tile_b/lane_chunk in {self}")
        if self.depth not in (1, 2):
            raise ValueError(f"depth must be 1 or 2, got {self.depth}")
        if self.grid not in GRID_LAYOUTS:
            raise ValueError(f"grid must be one of {GRID_LAYOUTS}, got {self.grid!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d})


#: what every op wrapper resolves when no table entry matches: 8 warps
#: per block (the schedule K2 ran before tuning), 32-lane gathers
FALLBACK = KernelConfig(tile_b=8, lane_chunk=32, depth=1, grid="qb")


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def shape_bucket(
    b: int | None = None, n: int | None = None, d: int | None = None
) -> str:
    """Bucket key for a (candidate-batch, series-length) shape: next
    powers of two, e.g. (200, 100) -> ``"b256n128"``; ``d > 1`` adds a
    ``d`` suffix, as in the reference."""
    bb = "*" if b is None else str(_pow2_at_least(max(int(b), 1)))
    nn = "*" if n is None else str(_pow2_at_least(max(int(n), 1)))
    if d is None or int(d) == 1:
        return f"b{bb}n{nn}"
    return f"b{bb}n{nn}d{_pow2_at_least(max(int(d), 1))}"


def search_space(family: str) -> tuple[KernelConfig, ...]:
    """The configs ``autotune`` sweeps for one family, fallback first
    (the fallback doubles as the bit-identity reference)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; known: {FAMILIES}")
    if family == "pipeline":
        return tuple(KernelConfig(lane_chunk=c) for c in (32, 8, 16, 64, 128))
    if family == "lb_fused":
        return tuple(
            KernelConfig(tile_b=t, grid=g) for t in (8, 4, 16, 32) for g in GRID_LAYOUTS
        )
    if family in ("lb_keogh", "lb_kim"):
        return tuple(KernelConfig(tile_b=t) for t in (8, 4, 16, 32))
    return (FALLBACK,)
