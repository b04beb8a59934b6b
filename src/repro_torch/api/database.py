"""Database: the build-once / query-many session facade (port of
``repro.api.database``).

    db = Database.build(data, SearchConfig())   # rows + envelopes on the GPU
    Database.build(x_nd)                        # (N, n, d): the multivariate tier
    db.plan(queries).explain()                  # see the routing
    res = db.search(queries)                    # scan, host or indexed driver
    db.save("session.npz"); Database.load(...)  # the reference's bundle
    Database.from_arrays(db.to_arrays())        # the same, in memory
    Database.build(data, tune=True)             # + the kernel tune sweep
    Database.build(data, index=True)            # + the stage-0 triangle index
    Database.build(data, anytime=True)          # + the anytime tier
    db.search(q, mode="anytime", budget=4096)   # best-so-far with error bounds
    db.search(q[:m])                            # a subsequence-length query
    db.stream(threshold=3.0, hop=2)             # rows as a stream's templates
    db.use_mesh(make_host_mesh())               # + the sharded driver

``build`` computes every database-side artifact once: the (z-normalized,
precision-cast) rows on the device, their warping envelopes (envelope
kernel), the float64 powered row norms, the planner's calibration probe
and, with ``index=True``, the stage-0 triangle index.  Bundles keep the
reference's ``.npz`` keys and format version, so a bundle written by
``repro.api.Database.save`` loads here and answers the same (``load`` /
``from_arrays``).  The session runs on
``device`` (default: the GPU; ``RuntimeError`` when there is none).

Multivariate data ``(N, n, d)`` is stored channel-major flattened, one
``(d*n,)`` row per series (``repro_torch.mv.layout``), z-normalized per
(row, channel), and searched under dependent DTW; queries are ``(n, d)``
or ``(Q, n, d)`` (or already flattened ``(Q, d*n)``).  ``(N, n, 1)`` data
is the univariate session, byte for byte.

``anytime=True`` (or a dict of options) builds the anytime tier's window
banks and cluster trees (``repro_torch.anytime``), saved and loaded as the
reference's ``any_*`` bundle keys.  ``search(mode="anytime", budget=)``
then explores it best-first (best-so-far top-k with sound per-answer
error bounds), and a query of one of its shorter lengths takes the exact
sweep over that tier's windows; both return ``AnytimeResult`` /
``AnytimeBatchResult``.

``use_mesh`` attaches a ``repro_torch.core.distributed.Mesh``: every
rank of the mesh holds the same session, uploads its shard of the padded
rows once, and the planner routes its searches through the sharded
driver, which every rank must then issue alike and in the same order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping

import numpy as np
import torch

from repro_torch.anytime.build import (
    AnytimeIndex,
    anytime_arrays,
    anytime_from_arrays,
    build_anytime_index,
)
from repro_torch.api.config import SearchConfig
from repro_torch.api.planner import (
    Calibration,
    CascadePlan,
    Plan,
    calibrate,
    choose_cascade,
    plan_search,
)
from repro_torch.core.cascade import (
    BatchSearchResult,
    SearchResult,
    nn_search_host,
    nn_search_indexed,
    nn_search_scan,
)
from repro_torch.core.distributed import pad_database, shard_database, sharded_nn_search
from repro_torch.index.build import TriangleIndex, build_index
from repro_torch.index.store import index_arrays, index_from_arrays
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.envelope.ops import envelope_op
from repro_torch.kernels.tuning import TuneTable, autotune_session, install
from repro_torch.mv.layout import flatten_channels
from repro_torch.stream.state import STD_EPS

BUNDLE_FORMAT_VERSION = 1


def _znorm_rows(rows: np.ndarray, eps: float = STD_EPS, dtype="float32") -> np.ndarray:
    """Per-row global z-normalization, vectorized over rows (the
    reference's arithmetic, in float64 numpy)."""
    x64 = np.asarray(rows, np.float64)
    mean = x64.mean(axis=1, keepdims=True)
    std = np.maximum(x64.std(axis=1, keepdims=True), eps)
    return ((x64 - mean) / std).astype(dtype)


def _znorm_channels(flat: np.ndarray, d: int, dtype) -> np.ndarray:
    """``_znorm_rows`` per (row, channel) of channel-major flattened
    (N, d*n) rows: each channel segment is its own series."""
    n_rows, total = flat.shape
    return _znorm_rows(flat.reshape(n_rows * d, total // d), dtype=dtype).reshape(
        n_rows, total
    )


def _torch_dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


class Database:
    """One searchable time-series database session.

    Construct with :meth:`build`, :meth:`load` or :meth:`from_arrays`.
    Artifacts are tied to the frozen :class:`SearchConfig`; per-call
    overrides are limited to ``k``, the driver and the method.
    """

    def __init__(
        self, *, raw, data: torch.Tensor, config: SearchConfig, w: int,
        upper: torch.Tensor, lower: torch.Tensor, row_sums, row_sumsq,
        calibration: Calibration | None = None, tune_table: TuneTable | None = None,
        index: TriangleIndex | None = None, anytime: AnytimeIndex | None = None,
        d: int = 1,
    ):
        self.raw = raw  # as given (precision-cast numpy), what save() persists
        # (N, d*n) rows on the device, channel-major flattened when d > 1,
        # znormed per (row, channel) when configured
        self._data = data
        self.d = int(d)  # channel count
        self.config = config
        self.w = w  # resolved band half-width
        self._upper = upper  # (N, d*n) row envelopes on the device (per segment)
        self._lower = lower
        self.row_sums = row_sums  # (N,) float64 sum x of the raw rows
        self.row_sumsq = row_sumsq  # (N,) float64 sum x^2
        self.index = index  # the stage-0 triangle index, or None
        # the anytime tier (window banks + cluster trees per length), or None
        self.anytime = anytime
        # measured schedules and stage costs of build(tune=...), persisted
        # as tune_* bundle keys; installing makes them what every kernel
        # wrapper resolves.  None on untuned sessions: the defaults hold.
        self.tune_table = tune_table
        if tune_table is not None:
            install(tune_table, merge=True)
        self._calibration = calibration
        self._cascade_cache: dict[int, CascadePlan] = {}
        self._fingerprint: str | None = None
        self.mesh = None  # set by use_mesh; bundles save no mesh

    # ------------------------------------------------------ constructors

    @classmethod
    def build(
        cls, data, config: SearchConfig | None = None, *,
        index: bool | TriangleIndex = False, n_refs: int = 8,
        n_clusters: int | None = None, seed: int = 0, anytime=False, tune=False,
        device=None,
    ) -> "Database":
        """Precompute every database-side artifact for ``data`` (N, n), or
        (N, n, d) multivariate series, on ``device``.

        ``index=True`` also builds the stage-0 triangle index (``n_refs``
        references by farthest-first traversal, the first ``n_clusters``
        of them cluster representatives, ``seed`` for the random draws:
        2R banded-DTW sweeps over the rows), and the planner then routes
        searches through it; pass a prebuilt
        :class:`~repro_torch.index.TriangleIndex` to attach one instead (it
        is validated against the data and config).

        ``tune=True`` runs the deterministic kernel tune sweep
        (``kernels.tuning.autotune_session``) on the session's device at
        its (min(block, N), n) shape: the fastest bit-identical schedule
        of every kernel family and the measured per-stage costs become
        the session's ``tune_table``, installed process-wide, saved in the
        bundle, and read by the planner for ``method="auto"``.  A dict
        customizes the sweep, e.g. ``tune=dict(iters=1, families=("lb_kim",
        "pipeline"))``.

        ``anytime=True`` builds the anytime tier over the whole-row length
        (its window bank is the stored rows tensor itself); a dict
        customizes it, e.g. ``anytime=dict(lengths=(64, n), hop=8,
        n_coarse=32, leaf_size=32)``, see
        :func:`repro_torch.anytime.build_anytime_index`.  Its radii are
        2·C·W DP sweeps on the session's device.  Univariate only
        (``ValueError`` on multivariate data, as in the reference)."""
        config = config if config is not None else SearchConfig()
        raw = np.asarray(data, dtype=config.precision)
        if raw.ndim == 3:
            d = int(raw.shape[2])
            if d == 1:
                raw = raw[:, :, 0]  # d = 1: the univariate session verbatim
        elif raw.ndim == 2:
            d = 1
        else:
            raise ValueError(
                f"data must be (N, n) equal-length series or (N, n, d) "
                f"multivariate series, got shape {raw.shape}"
            )
        if config.channels > 0 and config.channels != d:
            raise ValueError(
                f"config.channels={config.channels} but data has {d} "
                f"channel(s) (shape {raw.shape}); pass matching data or "
                f"channels=0 to infer"
            )
        if anytime and d > 1:
            raise ValueError(
                "anytime subsequence tier is univariate-only for now; "
                "build with anytime=False for multivariate data"
            )
        dev = resolve_device(device)
        n_db, n = raw.shape[0], raw.shape[1]
        if n < 2:
            raise ValueError(f"series length n={n} must be >= 2")
        w = config.resolve_w(n)
        config.validate_k(config.k, n_db)
        # channel-major flatten: (N, n, d) -> (N, d*n); d = 1 is the identity
        flat = flatten_channels(raw) if raw.ndim == 3 else raw
        rows = _znorm_channels(flat, d, config.precision) if config.znorm else flat
        raw64 = np.asarray(flat, np.float64)
        row_sums = raw64.sum(axis=1)
        row_sumsq = (raw64 * raw64).sum(axis=1)
        del raw64
        data_t = torch.as_tensor(rows, device=dev).contiguous()
        upper, lower = envelope_op(data_t, w, d)
        tri = None
        if index is True:
            tri = build_index(
                data_t, w=w, p=config.p, n_refs=n_refs, n_clusters=n_clusters, seed=seed,
                d=d,
            )
        elif isinstance(index, TriangleIndex):
            tri = index
            tri.validate(n_db, n, w, config.p, d)
            tri.validate_data(rows)
        elif index is not False:
            raise TypeError(
                f"index must be a bool or a prebuilt TriangleIndex, got "
                f"{type(index).__name__}"
            )
        any_idx = None
        if anytime:
            opts = dict(anytime) if isinstance(anytime, dict) else {}
            any_idx = build_anytime_index(
                raw, data_t, p=config.p, znorm=config.znorm, resolved_w=w,
                w_config=config.w, precision=config.precision,
                seed=opts.pop("seed", seed), **opts,
            )
        table = None
        if tune:
            opts = dict(tune) if isinstance(tune, dict) else {}
            table = autotune_session(
                n=n, b=opts.pop("b", min(config.block, n_db)), w=w, p=config.p,
                seed=opts.pop("seed", seed), device=dev, **opts,
            )
        cal = calibrate(data_t, w, config.p, d=d)
        return cls(
            raw=raw, data=data_t, config=config, w=w, upper=upper, lower=lower,
            row_sums=row_sums, row_sumsq=row_sumsq, calibration=cal,
            tune_table=table, index=tri, anytime=any_idx, d=d,
        )

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, np.ndarray], device=None) -> "Database":
        """A session from the reference's bundle arrays (``.npz`` keys:
        ``config_json``, ``resolved_w``, ``data``, ``upper``, ``lower``,
        ``row_sums``, ``row_sumsq`` and the optional ``channels``,
        ``idx_*``, ``cal_*``, ``any_*`` and ``tune_*``).  Saved artifacts are
        uploaded, not recomputed; a tune table is installed."""
        version = int(arrays["bundle_format_version"])
        if version != BUNDLE_FORMAT_VERSION:
            raise ValueError(
                f"database bundle format v{version} unsupported "
                f"(expected v{BUNDLE_FORMAT_VERSION})"
            )
        dev = resolve_device(device)
        config = SearchConfig.from_json(str(arrays["config_json"]))
        raw = np.asarray(arrays["data"], dtype=config.precision)
        # absent in univariate bundles
        d = int(arrays["channels"]) if "channels" in arrays else 1
        flat = flatten_channels(raw) if raw.ndim == 3 else raw
        rows = _znorm_channels(flat, d, config.precision) if config.znorm else flat
        tri = None
        if "idx_meta" in arrays:
            tri = index_from_arrays(
                {k[len("idx_"):]: arrays[k] for k in arrays if k.startswith("idx_")}
            )
        cal = None
        if "cal_stage_names" in arrays:
            cal = Calibration.from_arrays(
                {k[len("cal_"):]: arrays[k] for k in arrays if k.startswith("cal_")}
            )
        table = None
        if "tune_json" in arrays:
            table = TuneTable.from_arrays(
                {k[len("tune_"):]: arrays[k] for k in arrays if k.startswith("tune_")}
            )
        data_t = torch.as_tensor(rows, device=dev).contiguous()
        any_idx = None
        if "any_meta" in arrays:
            any_idx = anytime_from_arrays(
                {k[len("any_"):]: arrays[k] for k in arrays if k.startswith("any_")},
                device=dev, prepared=data_t,
            )
        dt = _torch_dtype(config.precision)
        return cls(
            raw=raw,
            data=data_t,
            config=config,
            w=int(arrays["resolved_w"]),
            upper=torch.as_tensor(np.asarray(arrays["upper"]), dtype=dt, device=dev),
            lower=torch.as_tensor(np.asarray(arrays["lower"]), dtype=dt, device=dev),
            row_sums=np.asarray(arrays["row_sums"]),
            row_sumsq=np.asarray(arrays["row_sumsq"]),
            calibration=cal,
            tune_table=table,
            index=tri,
            anytime=any_idx,
            d=d,
        )

    # ------------------------------------------------------- persistence

    def to_arrays(self) -> dict[str, np.ndarray]:
        """The bundle's arrays (the reference's keys), the stage-0 index and
        the anytime tier included: what :meth:`save` writes and
        :meth:`from_arrays` reads."""
        arrays: dict[str, np.ndarray] = {
            "bundle_format_version": np.int64(BUNDLE_FORMAT_VERSION),
            "config_json": np.str_(self.config.to_json()),
            "resolved_w": np.int64(self.w),
            "data": self.raw,
            "upper": self.upper,
            "lower": self.lower,
            "row_sums": self.row_sums,
            "row_sumsq": self.row_sumsq,
        }
        if self.d > 1:
            # absent means univariate, as in the reference's bundles
            arrays["channels"] = np.int64(self.d)
        if self.index is not None:
            arrays.update({f"idx_{k}": v for k, v in index_arrays(self.index).items()})
        if self._calibration is not None:
            arrays.update(
                {f"cal_{k}": v for k, v in self._calibration.to_arrays().items()}
            )
        if self.anytime is not None:
            arrays.update({f"any_{k}": v for k, v in anytime_arrays(self.anytime).items()})
        if self.tune_table is not None:
            arrays.update(
                {f"tune_{k}": v for k, v in self.tune_table.to_arrays().items()}
            )
        return arrays

    def save(self, path: str) -> str:
        """Persist the session to one ``.npz`` bundle (:meth:`to_arrays`)."""
        path = str(path) if str(path).endswith(".npz") else f"{path}.npz"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **self.to_arrays())
        return path

    @classmethod
    def load(cls, path: str, device=None) -> "Database":
        """Rebuild a session from a :meth:`save` bundle, this package's or
        the reference's."""
        path = str(path) if str(path).endswith(".npz") else f"{path}.npz"
        with np.load(path) as z:
            return cls.from_arrays({k: z[k] for k in z.files}, device=device)

    # -------------------------------------------------------- properties

    @property
    def device(self) -> torch.device:
        return self._data.device

    @property
    def rows_tensor(self) -> torch.Tensor:
        """The searched rows as the (N, d*n) tensor on the session's device."""
        return self._data

    @property
    def data(self) -> np.ndarray:
        """The searched rows (N, d*n) on the host: channel-major flattened
        and z-normalized as configured, as the reference's ``data``."""
        return self._data.cpu().numpy()

    @property
    def upper(self) -> np.ndarray:
        """(N, d*n) upper warping envelopes of the rows (per channel
        segment), band ``self.w``."""
        return self._upper.cpu().numpy()

    @property
    def lower(self) -> np.ndarray:
        return self._lower.cpu().numpy()

    @property
    def n_rows(self) -> int:
        return int(self._data.shape[0])

    @property
    def length(self) -> int:
        """Per-channel series length n (the flattened rows are d*n)."""
        return int(self._data.shape[1]) // self.d

    @property
    def channels(self) -> int:
        """Channel count d; 1 for univariate sessions."""
        return self.d

    @property
    def envelopes(self) -> tuple[np.ndarray, np.ndarray]:
        """(upper, lower) warping envelopes of the database rows."""
        return self.upper, self.lower

    @property
    def p(self):
        return self.config.p

    @property
    def fingerprint(self) -> str:
        """sha256 over the config's canonical JSON, the resolved band and
        the raw data bytes (the reference's serving-cache key)."""
        if self._fingerprint is None:
            import hashlib

            h = hashlib.sha256()
            h.update(self.config.stable_hash().encode())
            h.update(f"|w={self.w}|{self.raw.shape}|{self.raw.dtype}|".encode())
            h.update(np.ascontiguousarray(self.raw).tobytes())
            self._fingerprint = h.hexdigest()
        return self._fingerprint

    def row_mean_std(self, eps: float = STD_EPS) -> tuple[np.ndarray, np.ndarray]:
        """Per-row mean and (eps-floored) std of the raw rows, from the
        cached powered norms; multivariate rows pool all d*n values."""
        n = self.length * self.d
        mean = self.row_sums / n
        var = np.maximum(self.row_sumsq / n - mean * mean, 0.0)
        return mean, np.maximum(np.sqrt(var), eps)

    def __len__(self) -> int:
        return self.n_rows

    def __repr__(self) -> str:
        shape = f"{self.n_rows} x {self.length}" + (f" x {self.d}ch" if self.d > 1 else "")
        return (
            f"Database({shape}, w={self.w}, "
            f"p={self.config.p}, method={self.config.method!r}, "
            f"index={'R=%d' % self.index.n_refs if self.index else 'none'}, "
            f"anytime={list(self.anytime.lengths) if self.anytime else 'none'}, "
            f"mesh={'attached' if self.mesh is not None else 'none'}, "
            f"device={self.device})"
        )

    # ---------------------------------------------------------- sharding

    def use_mesh(self, mesh, axis_names=None, sync_every: int = 4) -> "Database":
        """Attach a device mesh: the planner then routes queries through
        the sharded driver.  The rows are padded to whole blocks of every
        shard and this rank's shard is copied to its device here, once."""
        axis_names = mesh.axes(axis_names)
        dbp, _ = pad_database(self.data, mesh, axis_names, block=self.config.block)
        self._db_sharded = shard_database(dbp, mesh, axis_names)
        self.mesh = mesh
        self._axis_names = axis_names
        self._sync_every = int(sync_every)
        return self

    # ----------------------------------------------------------- queries

    def _prepare_mv(self, qs: np.ndarray, queries) -> np.ndarray:
        """``prepare_queries`` on a d-channel session: (n, d) or (Q, n, d),
        or rows already flattened to (Q, d*n), -> flattened rows, znormed
        per (row, channel) when configured."""
        d, n = self.d, self.length
        if qs.ndim == 2 and qs.shape[1] == d * n:
            # already channel-major flattened rows; normalising prepared
            # rows again leaves them as they are
            return _znorm_channels(qs, d, self.config.precision) if self.config.znorm else qs
        single = qs.ndim == 2
        if single:
            qs = qs[None]
        if qs.ndim != 3 or qs.shape[-1] != d:
            raise ValueError(
                f"queries must be one (n, {d}) series or a (Q, n, {d}) batch on "
                f"this {d}-channel session, got shape {np.asarray(queries).shape}"
            )
        if qs.shape[1] != n:
            raise ValueError(
                f"query length {qs.shape[1]} != expected series length {n}: the "
                f"paper's DTW bounds assume equal lengths"
            )
        qs = flatten_channels(qs)
        if self.config.znorm:
            qs = _znorm_channels(qs, d, self.config.precision)
        return qs[0] if single else qs

    def prepare_queries(self, queries, length: int | None = None) -> np.ndarray:
        """The exact query array the drivers consume: precision-cast and
        (when the session z-norms) z-normalized, shape validated.
        ``length`` overrides the expected query length on a session with
        an anytime subsequence tier (default: the whole-row length).  On a
        multivariate session queries are one (n, d) series or a (Q, n, d)
        batch, returned channel-major flattened like the stored rows."""
        qs = np.asarray(queries, dtype=self.config.precision)
        if self.d > 1:
            return self._prepare_mv(qs, queries)
        if qs.ndim == 3 and qs.shape[-1] == 1:
            qs = qs[:, :, 0]
        if qs.ndim not in (1, 2):
            raise ValueError(
                f"queries must be one (n,) series or a (Q, n) batch, got "
                f"shape {qs.shape}"
            )
        expected = self.length if length is None else int(length)
        if qs.shape[-1] != expected:
            tiers = (
                f" (anytime tier lengths: {list(self.anytime.lengths)})"
                if self.anytime is not None
                else ""
            )
            raise ValueError(
                f"query length {qs.shape[-1]} != expected series length "
                f"{expected}: the paper's DTW bounds assume equal lengths{tiers}"
            )
        if self.config.znorm:
            single = qs.ndim == 1
            qs = _znorm_rows(qs[None] if single else qs, dtype=self.config.precision)
            if single:
                qs = qs[0]
        return qs

    def _config_for(self, method: str | None) -> SearchConfig:
        if method is None:
            return self.config
        return dataclasses.replace(self.config, method=method)

    @property
    def calibration(self) -> Calibration:
        """The planner's selectivity probe (measured here, once, when a
        bundle did not carry one)."""
        if self._calibration is None:
            self._calibration = calibrate(self._data, self.w, self.config.p, d=self.d)
        return self._calibration

    def _resolve_method(self, cfg: SearchConfig, k: int | None = None):
        """``method="auto"`` -> the calibration-chosen stage order."""
        if cfg.method != "auto":
            return cfg, None
        kk = cfg.k if k is None else int(k)
        cascade = self._cascade_cache.get(kk)
        if cascade is None:
            # a tuned session plans with its measured stage costs
            costs = self.tune_table.stage_costs if self.tune_table else None
            cascade = choose_cascade(self.calibration, k=kk, unit_costs=costs)
            self._cascade_cache[kk] = cascade
        return dataclasses.replace(cfg, method=cascade.method), cascade

    def _anytime_info(self, qlen: int | None = None) -> dict | None:
        """Tier summary for the planner (None when no tier is built), as
        the reference's."""
        if self.anytime is None:
            return None
        return {
            "lengths": list(self.anytime.lengths),
            "windows": self.anytime.n_windows,
            "clusters": self.anytime.n_clusters,
            "subsequence": qlen is not None and qlen != self.length,
        }

    def plan(self, queries=None, *, driver: str | None = None,
             method: str | None = None, k: int | None = None,
             mode: str = "exact", budget: int | None = None,
             length: int | None = None) -> Plan:
        """The routing decision ``search`` would take for ``queries`` (their
        shape only): under ``mode="anytime"`` the tier's route and budget,
        and for a univariate query of another length than the rows' (or
        ``length``) the subsequence route."""
        qlen = length
        if queries is None:
            n_queries = 1
        elif isinstance(queries, (int, np.integer)):
            n_queries = int(queries)
        else:
            arr = np.asarray(queries)
            # on a d-channel session (d*n,) and (n, d) are one query
            one = arr.ndim == 1 or (self.d > 1 and arr.ndim == 2 and arr.shape[-1] == self.d)
            n_queries = 1 if one else int(arr.shape[0])
            if self.d == 1 and arr.ndim in (1, 2) and qlen is None:
                qlen = int(arr.shape[-1])
        cfg, cascade = self._resolve_method(self._config_for(method), k)
        return plan_search(
            cfg, self.n_rows, n_queries, has_index=self.index is not None,
            has_mesh=self.mesh is not None, driver=driver, cascade=cascade, mode=mode,
            budget=budget, anytime_info=self._anytime_info(qlen), channels=self.d,
        )

    def search(self, queries, *, k: int | None = None, driver: str | None = None,
               method: str | None = None, mode: str = "exact",
               budget: int | None = None):
        """Nearest-neighbour search through the planned driver (scan, host,
        indexed or sharded).  One (n,) series -> ``SearchResult``; a (Q, n)
        batch -> ``BatchSearchResult`` ((n, d) and (Q, n, d) on a d-channel
        session).

        On a session built with ``anytime=...`` two more routes open, both
        returning :class:`repro_torch.anytime.AnytimeResult` (one query) or
        ``AnytimeBatchResult`` with window provenance: ``mode="anytime"``,
        best-first cluster exploration with a sound per-answer error bound
        (``budget`` caps the windows refined per query; ``None`` explores
        until the answer is exact and bit-matches ``mode="exact"``), and a
        query shorter than the rows, answered exactly (or anytime) over
        the tier of its length.  A whole-length exact search answers as
        the session without the tier."""
        if mode not in ("exact", "anytime"):
            raise ValueError(f"mode={mode!r} unknown; use 'exact' or 'anytime'")
        qlen = int(np.asarray(queries).shape[-1])
        if mode == "anytime" or (self.anytime is not None and qlen != self.length):
            return self._search_anytime(queries, qlen, k=k, driver=driver, method=method,
                                        mode=mode, budget=budget)
        if budget is not None:
            raise ValueError(
                "budget= only applies to mode='anytime' (exact search always "
                "explores everything)"
            )
        qs = self.prepare_queries(queries)
        k = self.config.validate_k(self.config.k if k is None else k, self.n_rows)
        plan = self.plan(qs, driver=driver, method=method, k=k)
        cfg = plan.config
        if plan.driver == "indexed":
            return nn_search_indexed(
                qs, self._data, self.index, k=k, block=cfg.block, method=cfg.method,
            )
        if plan.driver == "sharded":
            return sharded_nn_search(
                qs, self._db_sharded, self.mesh, axis_names=self._axis_names, w=self.w,
                p=cfg.p, k=k, block=cfg.block, sync_every=self._sync_every,
                method=cfg.method, d=self.d,
            )
        fn = nn_search_scan if plan.driver == "scan" else nn_search_host
        return fn(
            qs, self._data, w=self.w, p=cfg.p, k=k, block=cfg.block,
            method=cfg.method, d=self.d,
        )

    def _search_anytime(self, queries, qlen: int, *, k: int | None, driver: str | None,
                        method: str | None, mode: str, budget: int | None):
        """Route a query batch through the anytime tier (DESIGN.md §3.10)."""
        from repro_torch.anytime import anytime_search, exact_subsequence_search

        if self.anytime is None:
            raise ValueError(
                "mode='anytime' needs the anytime tier: build the session "
                "with Database.build(..., anytime=True) (or a dict of "
                "tier options)"
            )
        li = self.anytime.tier(qlen)  # raises with the built lengths listed
        single = np.asarray(queries).ndim == 1
        qs = np.atleast_2d(self.prepare_queries(queries, length=qlen))
        k = self.config.validate_k(self.config.k if k is None else k, li.n_windows)
        # the plan validates the route (driver conflicts, a budget in exact
        # mode) and resolves method="auto" as search() does
        plan = self.plan(qs, driver=driver, method=method, k=k, mode=mode, budget=budget)
        if plan.driver == "anytime":
            res = anytime_search(qs, self.anytime, k=k, method=plan.config.method,
                                 budget=plan.budget)
        else:
            res = exact_subsequence_search(qs, self.anytime, k=k, method=plan.config.method,
                                           block=plan.config.block)
        return res[0] if single else res

    def topk(self, queries, k: int, *, driver: str | None = None):
        """``search`` with an explicit neighbour count."""
        return self.search(queries, k=k, driver=driver)

    def classify(self, labels, queries, *, driver: str = "scan"):
        """1-NN classification against per-row ``labels`` (paper §7)."""
        labels = np.asarray(labels)
        if labels.shape != (self.n_rows,):
            raise ValueError(
                f"labels must be one label per database row "
                f"({self.n_rows},), got shape {labels.shape}"
            )
        res = self.search(queries, k=1, driver=driver)
        if isinstance(res, SearchResult):
            return int(labels[res.index])
        return np.asarray(labels[res.indices[:, 0]])

    # ---------------------------------------------------------- streaming

    def stream(
        self,
        templates=None,
        *,
        threshold,
        hop: int = 1,
        prefilter: bool = True,
        exclusion: int | None = None,
        capacity: int | None = None,
        eps: float = STD_EPS,
    ):
        """A :class:`repro_torch.stream.StreamMatcher` under this session's
        config (w, p, block, method, znorm), on the session's device.

        With ``templates=None`` the database rows are the template bank
        and the build-time envelopes are reused — constructing matchers
        per signal stops re-deriving them.  Explicit ``templates`` get
        their envelopes computed on construction (the envelope kernel).
        A d-channel session streams d-channel signals: its rows (N, n, d)
        are the bank, explicit templates are (n, d) or (Q, n, d), and
        ``push`` takes (m, d) chunks.
        """
        from repro_torch.stream.matcher import StreamMatcher

        cfg, _ = self._resolve_method(self.config)
        envelopes = None
        if templates is None:
            templates = self.raw
            # cached envelopes were computed on the (znormed) float32
            # rows with the default std floor; reuse them only when the
            # scanner would recompute exactly that
            if self.config.precision == "float32" and (
                not self.config.znorm or eps == STD_EPS
            ):
                envelopes = (self._upper, self._lower)
        return StreamMatcher(
            templates,
            self.w,
            threshold,
            p=self.config.p,
            hop=hop,
            znorm=self.config.znorm,
            block=self.config.block,
            method=cfg.method,
            prefilter=prefilter,
            exclusion=exclusion,
            capacity=capacity,
            eps=eps,
            envelopes=envelopes,
            d=self.d,
            device=self.device,
        )


__all__ = ["BUNDLE_FORMAT_VERSION", "BatchSearchResult", "Database", "SearchResult"]
