"""TuneTable: persisted kernel-config lookups and the process-active table
(port of ``repro.kernels.tuning.table``).

The table maps ``(family, backend, bucket) -> KernelConfig`` and carries
the measured per-stage unit costs the cascade planner reads
(``stage_costs``, in O(n)-sweep units).  The backend is a device type,
``"cuda"`` or ``"cpu"``.  Entries of other backends (``"tpu"``, ``"gpu"``)
in a bundle written by the reference are kept and saved back, but never
match a device of this package.

Resolution (:func:`resolve_config`) is what an op wrapper calls when its
``tile_b``/``grid``/``depth`` argument is ``None``: the exact
``(family, backend, bucket)`` entry first, then the backend and bucket
wildcards, then :data:`~repro_torch.kernels.tuning.space.FALLBACK`.
The JSON payload and its version are the reference's, so ``tune_*``
bundle keys load in both packages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json

from repro_torch.kernels.tuning.defaults import DEFAULT_ENTRIES
from repro_torch.kernels.tuning.space import FALLBACK, FAMILIES, KernelConfig, shape_bucket

#: version of the ``tune_*`` bundle-key payload (the reference's)
TUNE_FORMAT_VERSION = 1


def default_backend() -> str:
    """The backend key of the default device: ``"cuda"`` when there is a
    GPU, else ``"cpu"``.  A table key only; it runs nothing."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


@dataclasses.dataclass
class TuneTable:
    """Tuned schedule entries and measured stage costs, one session's worth."""

    entries: dict[tuple[str, str, str], KernelConfig] = dataclasses.field(
        default_factory=dict
    )
    #: measured per-candidate stage costs in O(n)-sweep units, keyed by
    #: stage name ("lb_kim", ..., "full"); empty = planner stays analytic
    stage_costs: dict[str, float] = dataclasses.field(default_factory=dict)

    def set(
        self, family: str, config: KernelConfig, *, bucket: str = "*",
        backend: str | None = None,
    ) -> None:
        if family not in FAMILIES:
            raise ValueError(f"unknown kernel family {family!r}; known: {FAMILIES}")
        backend = default_backend() if backend is None else backend
        self.entries[(family, backend, bucket)] = config

    def resolve(
        self, family: str, *, b: int | None = None, n: int | None = None,
        backend: str | None = None, d: int | None = None,
    ) -> KernelConfig:
        """Most-specific entry for ``family`` at shape ``(b, n[, d])``,
        else the fallback."""
        if family not in FAMILIES:
            raise ValueError(f"unknown kernel family {family!r}; known: {FAMILIES}")
        backend = default_backend() if backend is None else backend
        buckets = [shape_bucket(b, n, d)]
        legacy = shape_bucket(b, n)
        if legacy != buckets[0]:
            buckets.append(legacy)
        keys = [(family, backend, bucket) for bucket in buckets]
        keys.append((family, backend, "*"))
        keys += [(family, "*", bucket) for bucket in buckets]
        keys.append((family, "*", "*"))
        for key in keys:
            cfg = self.entries.get(key)
            if cfg is not None:
                return cfg
        return FALLBACK

    def merge(self, other: "TuneTable") -> "TuneTable":
        """Overlay ``other``'s entries and costs on this table."""
        self.entries.update(other.entries)
        self.stage_costs.update(other.stage_costs)
        return self

    # ------------------------------------------------------- persistence

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": TUNE_FORMAT_VERSION,
                "entries": [
                    {"family": fam, "backend": backend, "bucket": bucket,
                     "config": cfg.to_dict()}
                    for (fam, backend, bucket), cfg in sorted(self.entries.items())
                ],
                "stage_costs": dict(sorted(self.stage_costs.items())),
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, payload: str) -> "TuneTable":
        d = json.loads(payload)
        version = int(d.get("version", -1))
        if version != TUNE_FORMAT_VERSION:
            raise ValueError(
                f"tune table format v{version} unsupported "
                f"(expected v{TUNE_FORMAT_VERSION})"
            )
        table = cls()
        for e in d["entries"]:
            table.entries[(e["family"], e["backend"], e["bucket"])] = (
                KernelConfig.from_dict(e["config"])
            )
        table.stage_costs = {str(k): float(v) for k, v in d.get("stage_costs", {}).items()}
        return table

    def to_arrays(self) -> dict:
        """Bundle serialization (``tune_*`` keys in ``Database.save``)."""
        import numpy as np

        return {"version": np.int64(TUNE_FORMAT_VERSION), "json": np.str_(self.to_json())}

    @classmethod
    def from_arrays(cls, arrays: dict) -> "TuneTable":
        return cls.from_json(str(arrays["json"]))

    @classmethod
    def with_defaults(cls) -> "TuneTable":
        """A fresh table seeded with the per-backend defaults."""
        return cls(entries=dict(DEFAULT_ENTRIES))


#: the table every ``resolve_config`` consults
_ACTIVE = TuneTable.with_defaults()


def active_table() -> TuneTable:
    return _ACTIVE


def install(table: TuneTable, *, merge: bool = True) -> TuneTable:
    """Make ``table`` the process-active resolution source; ``merge=True``
    overlays it on the defaults.  Returns the now-active table."""
    global _ACTIVE
    _ACTIVE = TuneTable.with_defaults().merge(table) if merge else table
    return _ACTIVE


@contextlib.contextmanager
def use_table(table: TuneTable, *, merge: bool = False):
    """Scoped ``install``: the previous active table is restored on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = TuneTable.with_defaults().merge(table) if merge else table
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def resolve_config(
    family: str, *, b: int | None = None, n: int | None = None,
    backend: str | None = None, d: int | None = None,
) -> KernelConfig:
    """Resolve one kernel family's schedule from the active table."""
    return _ACTIVE.resolve(family, b=b, n=n, backend=backend, d=d)
