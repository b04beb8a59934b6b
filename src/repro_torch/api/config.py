"""SearchConfig: the frozen per-database search contract (port of
``repro.api.config``; same fields, messages, JSON form and hash).

Every knob the five legacy entry points used to take as overlapping
kwargs lives here once, validated at construction with actionable
messages.  A config is frozen because the build-once artifacts of a
:class:`repro_torch.api.Database` (envelopes, powered norms, the stage-0
index) are only valid for the exact ``(w, p, precision, znorm)`` they
were computed under — changing a knob means building a new session, the
same rule the triangle index has always enforced via ``validate``.

Serialization is JSON (``to_json``/``from_json``) so the whole config
rides inside the one-file ``.npz`` bundle ``Database.save`` writes;
``p = inf`` round-trips as the string ``"inf"``.
"""

from __future__ import annotations

import dataclasses
import json
import math

from repro_torch.core.dtw import PNorm
from repro_torch.core.pipeline import PIPELINES, Method

#: norm orders the cascade kernels are specialised for (elementwise |.|,
#: squared, and the max-combine DP); other p values remain available
#: through the low-level ``repro_torch.core`` entry points.
SUPPORTED_P = (1, 2, math.inf)

SUPPORTED_PRECISION = ("float32", "float64")


def _normalize_p(p) -> PNorm:
    """1/2 -> int, any spelling of infinity -> float('inf'); raise on
    everything else with the supported set spelled out."""
    try:
        v = float(p)
    except (TypeError, ValueError):
        raise ValueError(
            f"p={p!r} is not a norm order; the session API serves the "
            f"kernel-specialised norms p in {{1, 2, inf}}"
        ) from None
    if math.isinf(v) and v > 0:
        return math.inf
    if v in (1.0, 2.0):
        return int(v)
    raise ValueError(
        f"p={p!r} unsupported: the session API serves the kernel-"
        f"specialised norms p in {{1, 2, inf}}; for other orders use the "
        f"low-level repro_torch.core.cascade functions directly"
    )


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Search parameters a :class:`repro_torch.api.Database` is built under.

    * ``w``      — Sakoe-Chiba band half-width; 0 means the paper's
      locality default ``n // 10``, resolved against the data at build.
    * ``p``      — norm order of DTW_p: 1, 2 or ``inf``.
    * ``k``      — neighbours returned per query (overridable per call
      via ``Database.topk``).
    * ``block``  — candidates per cascade block sweep.
    * ``method`` — stage pipeline (``repro_torch.core.pipeline.PIPELINES``):
      ``"lb_improved"`` (paper Algorithm 3), ``"lb_keogh"``,
      ``"lb_webb"``, ``"kim_improved"``, ``"kim_webb"``, ``"full"``, the
      TC-DTW cascades ``"tc_box"`` and ``"tc_tri"`` — or ``"auto"``, which defers the stage order to the calibration-
      driven cascade planner (``repro_torch.api.planner.choose_cascade``);
      all pipelines return bit-identical results, only cost differs.
    * ``znorm``  — z-normalize database rows at build and queries per
      call (per-window for streaming).  Multivariate data is normalized
      per (row, channel).
    * ``precision`` — dtype of the stored artifacts: ``"float32"``
      (default) or ``"float64"``.
    * ``channels`` — number of data channels ``d``. 0 (default) infers
      from the build data's shape: (N, n) or (N, n, 1) builds the
      univariate tier, (N, n, d) the multivariate one (dependent DTW,
      channel-summed bounds — DESIGN.md §3.12).  A value > 0 is a
      contract: build rejects data whose channel count differs.
    """

    w: int = 0
    p: PNorm = 1
    k: int = 1
    block: int = 32
    method: Method = "lb_improved"
    znorm: bool = False
    precision: str = "float32"
    channels: int = 0

    def __post_init__(self):
        object.__setattr__(self, "p", _normalize_p(self.p))
        object.__setattr__(self, "w", int(self.w))
        object.__setattr__(self, "k", int(self.k))
        object.__setattr__(self, "block", int(self.block))
        object.__setattr__(self, "znorm", bool(self.znorm))
        object.__setattr__(self, "channels", int(self.channels))
        if self.channels < 0:
            raise ValueError(
                f"channels={self.channels} is negative; use channels >= 1 "
                f"for an explicit channel contract or 0 to infer from data"
            )
        if self.w < 0:
            raise ValueError(
                f"w={self.w} is negative; use w >= 1 for an explicit band "
                f"half-width or w=0 for the paper's n // 10 default"
            )
        if self.k < 1:
            raise ValueError(f"k={self.k} must be >= 1 neighbours per query")
        if self.block <= 0:
            raise ValueError(
                f"block={self.block} must be a positive number of candidate "
                f"lanes per sweep (32-256 are typical; it only affects "
                f"performance, never results)"
            )
        if self.method != "auto" and self.method not in PIPELINES:
            raise ValueError(
                f"method={self.method!r} unknown; available stage pipelines: "
                f"{sorted(PIPELINES)} (or 'auto' for the calibrated planner)"
            )
        if self.precision not in SUPPORTED_PRECISION:
            raise ValueError(
                f"precision={self.precision!r} unsupported; choose one of "
                f"{SUPPORTED_PRECISION}"
            )

    # ------------------------------------------------------- resolution

    def resolve_w(self, n: int) -> int:
        """The effective band half-width for series length ``n``.

        ``w == 0`` resolves to the paper's ``n // 10`` locality default;
        an explicit ``w >= n`` is rejected (the band ``|i - j| <= w``
        would be the unconstrained DP, and every cached envelope would
        be a constant) rather than silently clamped.
        """
        if self.w >= n:
            raise ValueError(
                f"w={self.w} >= series length n={n}: the Sakoe-Chiba band "
                f"must satisfy w <= n - 1; use w=0 for the n // 10 default"
            )
        return self.w if self.w > 0 else max(n // 10, 1)

    def validate_k(self, k: int, n_db: int) -> int:
        """Check a per-call (or configured) ``k`` against the database."""
        k = int(k)
        if k < 1:
            raise ValueError(f"k={k} must be >= 1 neighbours per query")
        if k > n_db:
            raise ValueError(
                f"k={k} > database size {n_db}: a top-k cannot return more "
                f"neighbours than there are candidate series"
            )
        return k

    # ---------------------------------------------------- serialization

    def stable_hash(self) -> str:
        """sha256 of the canonical (sorted-keys) JSON form: the config
        component of serving cache keys (``Database.fingerprint``).
        Stable across processes, unlike ``hash()``."""
        import hashlib

        return hashlib.sha256(self.to_json().encode()).hexdigest()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if math.isinf(d["p"]):
            d["p"] = "inf"
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "SearchConfig":
        d = dict(d)
        if d.get("p") == "inf":
            d["p"] = math.inf
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "SearchConfig":
        return cls.from_dict(json.loads(s))
