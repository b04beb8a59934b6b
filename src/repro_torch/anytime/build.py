"""Anytime-tier build phase + bundle (de)serialization (port of
``repro.anytime.build``).

``build_anytime_index`` runs the whole build: slice each length of
interest into its window bank (``slices``), sketch it with PAA, and grow
the two-level cluster tree (``cluster``; its radii are K5 sweeps on the
session's device).  Each tier's window bank is a tensor on that device,
the tree and the provenance arrays stay numpy.  ``anytime_arrays`` and
``anytime_from_arrays`` write and read the reference's ``any_*`` bundle
keys and dtypes (per-length namespaces ``L{m}_...``), so a bundle loads
in either package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from repro_torch.anytime.cluster import ClusterTree, build_tree
from repro_torch.anytime.slices import paa_sketch, slice_windows
from repro_torch.core.dtw import PNorm
from repro_torch.kernels.common import resolve_device

__all__ = [
    "LengthIndex",
    "AnytimeIndex",
    "build_anytime_index",
    "anytime_arrays",
    "anytime_from_arrays",
]

#: bumped when the any_* array layout changes; loading an unknown
#: version fails loudly (a stale tree silently breaks the error bound).
ANYTIME_FORMAT_VERSION = 1

_TREE_FIELDS = (
    "rep_gid",
    "radii_w",
    "min_radii_wide",
    "cmin0",
    "cmax0",
    "leaf_start",
    "cmin1",
    "cmax1",
    "member_start",
    "members",
)


@dataclasses.dataclass(frozen=True)
class LengthIndex:
    """One length-of-interest tier: window bank + cluster tree.

    ``wins`` is the full-resolution candidate bank in global-id order (the
    exact sweep's order), a tensor on the session's device;
    ``row_ids``/``starts`` map global window ids back to their ``(row,
    start)``; ``w`` is the band this tier's radii and refinement run at.
    ``cache`` holds the tree arrays the query phase reads, uploaded to the
    bank's device at the tier's first query (``anytime.search``); it is
    not part of the bundle.
    """

    m: int
    hop: int
    w: int
    wins: torch.Tensor  # (W, m) session precision, on the session's device
    row_ids: np.ndarray  # (W,) int64
    starts: np.ndarray  # (W,) int64
    tree: ClusterTree
    cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @property
    def n_windows(self) -> int:
        return int(self.wins.shape[0])


@dataclasses.dataclass(frozen=True)
class AnytimeIndex:
    """The anytime tier: one :class:`LengthIndex` per length of interest."""

    p: PNorm
    znorm: bool
    by_len: dict[int, LengthIndex]

    @property
    def lengths(self) -> tuple[int, ...]:
        return tuple(sorted(self.by_len))

    @property
    def n_windows(self) -> int:
        return sum(li.n_windows for li in self.by_len.values())

    @property
    def n_clusters(self) -> int:
        return sum(li.tree.n_leaves for li in self.by_len.values())

    def tier(self, m: int) -> LengthIndex:
        if m not in self.by_len:
            raise ValueError(
                f"no anytime tier for query length {m}; built lengths are "
                f"{list(self.lengths)} — rebuild with "
                f"anytime=dict(lengths=(..., {m}))"
            )
        return self.by_len[m]

    def __repr__(self) -> str:
        tiers = ", ".join(
            f"{m}:{li.n_windows}w/{li.tree.n_leaves}c"
            for m, li in sorted(self.by_len.items())
        )
        return f"AnytimeIndex(p={self.p}, lengths=[{tiers}])"


def default_hop(m: int) -> int:
    """Default window stride: m // 4 keeps ~4x overlap without the
    quadratic bank a stride of 1 would build."""
    return max(1, m // 4)


def build_anytime_index(
    raw: np.ndarray,
    prepared,
    *,
    p: PNorm,
    znorm: bool,
    resolved_w: int,
    w_config: int,
    precision: str,
    lengths: tuple[int, ...] | None = None,
    hop: int | None = None,
    paa: int | None = None,
    n_coarse: int | None = None,
    leaf_size: int = 32,
    radii: bool = True,
    seed: int = 0,
    device=None,
) -> AnytimeIndex:
    """Build the anytime tier over the database rows.

    ``raw`` are the as-given rows (numpy), ``prepared`` the session's
    stored rows (z-normalized per row when the config says so): a tensor,
    whose device the tier lives on, or an array uploaded to ``device``
    (default: the GPU).  The whole-row length ``m == n`` takes the
    ``prepared`` tensor itself as its window bank, with no copy: the
    bytes the exact drivers scan.  Shorter lengths slice ``raw`` on the
    host (z-norm per *window*, the streaming convention) and are uploaded
    once.

    Per-length band: the session's resolved ``w`` clamped to ``m - 1``,
    or the paper's ``m // 10`` default when the config left ``w = 0``.
    """
    raw = np.asarray(raw)
    n_rows, n = raw.shape
    lengths = tuple(sorted({int(m) for m in (lengths or (n,))}))
    for m in lengths:
        if not 2 <= m <= n:
            raise ValueError(
                f"anytime length {m} out of range: need 2 <= m <= row "
                f"length {n}"
            )
    dev = resolve_device(device, like=prepared)
    by_len: dict[int, LengthIndex] = {}
    for m in lengths:
        hop_m = int(hop) if hop is not None else default_hop(m)
        if m == n:
            wins_dev = torch.as_tensor(prepared, device=dev)
            wins = wins_dev.cpu().numpy()
            row_ids = np.arange(n_rows, dtype=np.int64)
            starts = np.zeros(n_rows, dtype=np.int64)
        else:
            wins, row_ids, starts = slice_windows(
                raw, m, hop_m, znorm=znorm, dtype=np.dtype(precision)
            )
            wins_dev = torch.as_tensor(wins, device=dev)
        w_m = (
            min(resolved_w, m - 1) if w_config > 0 or m == n
            else max(m // 10, 1)
        )
        sketch = paa_sketch(wins, paa if paa is not None else min(16, m))
        n_win = wins.shape[0]
        n_c = (
            int(n_coarse)
            if n_coarse is not None
            else min(32, max(1, int(math.isqrt(n_win))))
        )
        tree = build_tree(
            wins,
            sketch,
            n_coarse=n_c,
            leaf_size=leaf_size,
            w=w_m,
            p=p,
            radii=radii,
            seed=seed,
            wins_dev=wins_dev,
        )
        by_len[m] = LengthIndex(
            m=m,
            hop=hop_m,
            w=w_m,
            wins=wins_dev,
            row_ids=row_ids,
            starts=starts,
            tree=tree,
        )
    return AnytimeIndex(p=p, znorm=znorm, by_len=by_len)


# ------------------------------------------------------- serialization


def anytime_arrays(index: AnytimeIndex) -> dict[str, np.ndarray]:
    """Flat array dict for the bundle (scalars in ``meta`` vectors), the
    reference's keys and dtypes; window banks are read back to the host."""
    out: dict[str, np.ndarray] = {
        "meta": np.asarray(
            [
                ANYTIME_FORMAT_VERSION,
                float(index.p),
                float(bool(index.znorm)),
            ],
            np.float64,
        ),
        "lengths": np.asarray(index.lengths, np.int64),
    }
    for m, li in index.by_len.items():
        pre = f"L{m}_"
        out[pre + "meta"] = np.asarray([li.m, li.hop, li.w], np.float64)
        out[pre + "wins"] = li.wins.cpu().numpy()
        out[pre + "row_ids"] = li.row_ids
        out[pre + "starts"] = li.starts
        for f in _TREE_FIELDS:
            out[pre + f] = getattr(li.tree, f)
    return out


def anytime_from_arrays(
    z: Mapping, device=None, prepared: torch.Tensor | None = None
) -> AnytimeIndex:
    """Rebuild an :class:`AnytimeIndex` from ``anytime_arrays`` output (or
    an open ``.npz`` holding the same keys), window banks on ``device``
    (default: the GPU, or the device of ``prepared``).  A whole-row tier
    whose windows equal ``prepared``, the session's stored rows, takes
    that tensor as its bank instead of a second copy."""
    version, p, znorm = np.asarray(z["meta"], np.float64)
    if int(version) != ANYTIME_FORMAT_VERSION:
        raise ValueError(
            f"anytime tier format v{int(version)} unsupported (expected "
            f"v{ANYTIME_FORMAT_VERSION}); rebuild the bundle"
        )
    p = math.inf if math.isinf(p) else int(p)
    dev = resolve_device(device, like=prepared)
    by_len: dict[int, LengthIndex] = {}
    for m in np.asarray(z["lengths"], np.int64):
        m = int(m)
        pre = f"L{m}_"
        m_meta, hop, w = np.asarray(z[pre + "meta"], np.float64)
        tree = ClusterTree(**{f: np.asarray(z[pre + f]) for f in _TREE_FIELDS})
        wins = np.asarray(z[pre + "wins"])
        rows = (
            prepared.cpu().numpy()
            if prepared is not None and wins.shape == tuple(prepared.shape)
            else None
        )
        if rows is not None and wins.dtype == rows.dtype and np.array_equal(wins, rows):
            wins_dev = prepared
        else:
            wins_dev = torch.as_tensor(wins, device=dev)
        by_len[m] = LengthIndex(
            m=int(m_meta),
            hop=int(hop),
            w=int(w),
            wins=wins_dev,
            row_ids=np.asarray(z[pre + "row_ids"]),
            starts=np.asarray(z[pre + "starts"]),
            tree=tree,
        )
    return AnytimeIndex(p=p, znorm=bool(znorm), by_len=by_len)
