"""Planner: pick a driver and a stage order, explainably (port of
``repro.api.planner``).

``Database.search`` routes every query batch through ``plan_search``: the
anytime tier's explorer under ``mode="anytime"`` and its exact window
sweep for a subsequence-length query (a session built with
``anytime=...``); else the indexed driver when the session has a stage-0
triangle index, else the sharded driver when a mesh is attached
(``Database.use_mesh``), else the scan driver below ``SMALL_DB_ROWS``
rows (and for ``method="full"``), the host driver otherwise.
``calibrate`` measures every registered bound on a small probe sample at
build time and ``choose_cascade`` picks the cheapest predicted pipeline
for ``method="auto"``; every pipeline returns the same answers, only cost
differs.  A tuned session (``Database.build(tune=...)``) plans with its
measured stage costs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.config import SearchConfig
from repro_torch.core.pipeline import PIPELINES

#: planner-eligible drivers and the entry point each routes to.
DRIVERS = {
    "scan": "repro_torch.core.cascade.nn_search_scan",
    "host": "repro_torch.core.cascade.nn_search_host",
    "indexed": "repro_torch.core.cascade.nn_search_indexed",
    "sharded": "repro_torch.core.distributed.sharded_nn_search",
    "anytime": "repro_torch.anytime.search.anytime_search",
    "subsequence": "repro_torch.anytime.search.exact_subsequence_search",
}

#: below this many candidate rows the scan driver is chosen, above it the
#: host driver (the reference's rule, unchanged).
SMALL_DB_ROWS = 1024

#: LB stages the calibration probe measures, in tightness order.
CALIBRATED_STAGES = ("lb_kim", "lb_keogh", "lb_improved", "lb_webb")

#: analytic per-candidate unit costs in O(n)-sweep units (the reference's
#: table); the exact DP costs ``full_dp_cost(w)``.  The TC-DTW stages
#: reduce a lane to O(d*S) scalars (tc_box) or O(R) arithmetic (tc_tri).
STAGE_UNIT_COST = {
    "lb_kim": 1.0,
    "lb_keogh": 3.0,
    "lb_improved": 8.0,
    "lb_webb": 9.0,
    "tc_box": 0.6,
    "tc_tri": 0.4,
}

#: the TC-DTW stages, listed by ``Plan.explain`` where a plan weighed them
MV_STAGES = ("tc_box", "tc_tri")


def full_dp_cost(w: int) -> float:
    """Banded-DP cost per candidate, in O(n)-sweep units: one band row
    of ``2w + 1`` cells per series sample."""
    return 2.0 * float(w) + 1.0


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured probe: every registered bound over a (q, c) row sample.

    ``bounds[s, i, j]`` is the powered ``stage_names[s]`` bound between
    probe query ``i`` and sampled candidate ``j``; ``dtw[i, j]`` the
    true powered banded DTW.  Built once at ``Database.build``
    (``calibrate``), persisted in the bundle, consumed by
    ``choose_cascade`` — planning never re-measures.
    """

    stage_names: tuple[str, ...]
    bounds: np.ndarray  # (S, q, c) powered stage bounds
    dtw: np.ndarray  # (q, c) powered banded DTW
    w: int  # band the probe ran at (pins full_dp_cost)

    def to_arrays(self) -> dict[str, np.ndarray]:
        """Bundle serialization (``cal_*`` keys in ``Database.save``)."""
        return {
            "stage_names": np.asarray(self.stage_names),
            "bounds": self.bounds,
            "dtw": self.dtw,
            "w": np.int64(self.w),
        }

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray]) -> "Calibration":
        return cls(
            stage_names=tuple(str(s) for s in arrays["stage_names"]),
            bounds=np.asarray(arrays["bounds"], np.float64),
            dtw=np.asarray(arrays["dtw"], np.float64),
            w=int(arrays["w"]),
        )


def calibrate(rows, w: int, p, sample_q: int = 4, sample_c: int = 128, d: int = 1,
              device=None) -> Calibration:
    """Measure every registered bound on a small sample of ``rows``.

    Evenly-spaced rows stand in for queries (``sample_q``) against an
    evenly-spaced candidate subsample (``sample_c``); the four powered
    bounds and the true powered DTW are computed for every probe pair, on
    the rows' device (through the kernels on CUDA).  ``d > 1`` probes the
    multivariate forms on channel-major flattened rows and also measures
    ``tc_box``, which makes the ``"tc_box"`` pipeline eligible under
    ``method="auto"``; at d = 1 no tc stage is probed.
    """
    from repro_torch.core import lb as lb_mod
    from repro_torch.core.pipeline import query_webb_envelopes
    from repro_torch.kernels.common import resolve_device
    from repro_torch.kernels.dtw.ops import dtw_qbatch_op
    from repro_torch.kernels.envelope.ops import envelope_op
    from repro_torch.kernels.lb_improved.ops import lb_improved_qbatch_op
    from repro_torch.kernels.lb_keogh.ops import lb_keogh_qbatch_op
    from repro_torch.kernels.lb_kim.ops import lb_kim_qbatch_op
    from repro_torch.mv import tc as tc_mod

    d = int(d)
    dev = resolve_device(device, like=rows)
    rows = torch.as_tensor(rows, device=dev)
    n_db = rows.shape[0]
    qi = np.unique(np.linspace(0, n_db - 1, min(sample_q, n_db)).astype(np.int64))
    ci = np.unique(np.linspace(0, n_db - 1, min(sample_c, n_db)).astype(np.int64))
    qs = rows[torch.as_tensor(qi, device=dev)].contiguous()
    cs = rows[torch.as_tensor(ci, device=dev)].contiguous()
    upper, lower = envelope_op(qs, w, d)
    cand_u, cand_l = envelope_op(cs, w, d)
    q_ul, q_lu = query_webb_envelopes(upper, lower, w, d)

    def host(t):
        return t.double().cpu().numpy()

    rows_b = [
        host(lb_kim_qbatch_op(cs, qs, None, p)),
        host(lb_keogh_qbatch_op(cs, upper, lower, p)[0]),
        host(lb_improved_qbatch_op(cs, qs, upper, lower, w, p, d=d)),
        host(lb_mod.lb_webb_powered_qbatch(
            cs, qs, upper, lower, w, p, q_ul=q_ul, q_lu=q_lu,
            cand_u=cand_u, cand_l=cand_l,
        )),
    ]
    names = CALIBRATED_STAGES
    if d > 1:
        names = names + ("tc_box",)
        rows_b.append(host(tc_mod.tc_box_powered_qbatch(cs, upper, lower, p, d)))
    dtw = host(dtw_qbatch_op(qs, cs, w, p, d=d))
    return Calibration(names, np.stack(rows_b), dtw, int(w))


@dataclasses.dataclass(frozen=True)
class CascadePlan:
    """One stage-order decision: the chosen pipeline + its cost model.

    ``enter_frac[j]`` is the predicted fraction of candidates that
    reach ``stages[j]`` (survivors of every earlier bound at the probe
    sample's k-th best threshold); ``stage_cost[j]`` the per-candidate
    unit cost of running it; ``cost_per_candidate`` their dot product —
    the objective ``choose_cascade`` minimized.  ``predicted`` maps
    every candidate pipeline to its predicted cost.
    """

    method: str  # the chosen PIPELINES key
    stages: tuple[str, ...]
    enter_frac: tuple[float, ...]
    stage_cost: tuple[float, ...]
    cost_per_candidate: float
    k: int
    predicted: tuple[tuple[str, float], ...]  # (method, cost), sorted
    #: per-stage cost provenance, "measured" (tune sweep) or "analytic"
    #: (STAGE_UNIT_COST / full_dp_cost); empty on pre-tuning plans
    cost_source: tuple[str, ...] = ()

    def explain(self) -> str:
        lines = [
            f"cascade: {' -> '.join(self.stages)} (method={self.method}, "
            f"calibrated at k={self.k})",
            f"predicted cost/candidate: {self.cost_per_candidate:.2f} "
            f"O(n)-sweep units",
        ]
        src = self.cost_source or ("analytic",) * len(self.stages)
        measured = sorted({s for s, o in zip(self.stages, src) if o == "measured"})
        lines.append(
            "unit costs: measured by the kernel tune sweep for "
            + ", ".join(measured)
            + ("; analytic elsewhere" if len(measured) < len(set(self.stages)) else "")
            if measured
            else "unit costs: analytic (no tune sweep measured)"
        )
        for s, f, c, o in zip(self.stages, self.enter_frac, self.stage_cost, src):
            lines.append(
                f"  {s:<12} enter {100 * f:6.2f}%  unit cost {c:5.1f} "
                f"[{o}]  -> {f * c:6.2f}"
            )
        others = ", ".join(
            f"{m}={c:.2f}" for m, c in self.predicted if m != self.method
        )
        if others:
            lines.append(f"rejected: {others}")
        return "\n".join(lines)


def choose_cascade(
    cal: Calibration, k: int = 1, methods=None, unit_costs=None
) -> CascadePlan:
    """Pick the cheapest predicted stage order from the calibration.

    For each candidate pipeline the probe sample is pushed through its
    stages: a pair survives stage ``s`` iff ``bound_s < t_i`` where
    ``t_i`` is probe query ``i``'s k-th smallest sampled powered DTW.
    Predicted cost per candidate is ``sum_j unit_cost_j * enter_frac_j``,
    the banded DP included.  Deterministic: ties break on (cost, stage
    count, name).

    ``unit_costs``, when given, maps stage names (and/or ``"full"``) to
    *measured* per-candidate costs in the same O(n)-sweep units (a tune
    sweep's ``measure_stage_costs``); they override the analytic table
    stage by stage, and ``cost_source`` records which source each stage
    used.
    """
    if methods is None:
        methods = sorted(
            m
            for m, stages in PIPELINES.items()
            if all(s in cal.stage_names or s == "full" for s in stages)
        )
    unit_costs = unit_costs or {}
    bound_of = {s: cal.bounds[i] for i, s in enumerate(cal.stage_names)}
    kk = min(int(k), cal.dtw.shape[1])
    thr = np.sort(cal.dtw, axis=1)[:, kk - 1][:, None]  # (q, 1)

    def stage_cost(s):
        if s in unit_costs:
            return float(unit_costs[s]), "measured"
        if s == "full":
            return full_dp_cost(cal.w), "analytic"
        return STAGE_UNIT_COST[s], "analytic"

    scored = []
    for m in methods:
        stages = PIPELINES[m]
        alive = np.ones_like(cal.dtw, dtype=bool)
        fracs, costs, srcs = [], [], []
        for s in stages:
            fracs.append(float(alive.mean()))
            c, src = stage_cost(s)
            costs.append(c)
            srcs.append(src)
            if s != "full":
                alive = alive & (bound_of[s] < thr)
        total = float(np.dot(fracs, costs))
        scored.append((total, len(stages), m, tuple(fracs), tuple(costs), tuple(srcs)))
    scored.sort(key=lambda t: (t[0], t[1], t[2]))
    total, _, method, fracs, costs, srcs = scored[0]
    return CascadePlan(
        method=method,
        stages=PIPELINES[method],
        enter_frac=fracs,
        stage_cost=costs,
        cost_per_candidate=total,
        k=kk,
        predicted=tuple(
            (m, t) for t, _, m, _, _, _ in sorted(scored, key=lambda t: t[0])
        ),
        cost_source=srcs,
    )


@dataclasses.dataclass(frozen=True)
class Plan:
    """One routing decision: driver + stage order + why.  ``mode`` and
    ``budget`` carry the anytime tier's decision: under ``mode="anytime"``
    the answer's quality, not only its cost, is the planner's."""

    driver: str  # a DRIVERS key
    stages: tuple[str, ...]
    reasons: tuple[str, ...]
    n_queries: int
    config: SearchConfig
    cascade: CascadePlan | None = None  # set when the planner chose the order
    mode: str = "exact"  # "exact" | "anytime"
    budget: int | None = None  # refined windows per query; None = unlimited
    channels: int = 1  # data channel count d

    def _mv_considered(self) -> tuple[str, ...]:
        """TC-DTW stages this plan weighed: those of the chosen pipeline
        and, under method="auto", of every pipeline the chooser scored."""
        seen = {s for s in self.stages if s in MV_STAGES}
        if self.cascade is not None:
            for m, _cost in self.cascade.predicted:
                seen |= {s for s in PIPELINES[m] if s in MV_STAGES}
        return tuple(sorted(seen))

    def explain(self) -> str:
        mv = self._mv_considered()
        lines = [
            f"driver: {self.driver} ({DRIVERS[self.driver]})",
            f"stages: {' -> '.join(self.stages)}",
            f"queries: {self.n_queries} (method={self.config.method}, "
            f"p={self.config.p}, k={self.config.k}, "
            f"block={self.config.block})",
            f"channels: {self.channels} (mv stages considered: "
            f"{', '.join(mv) if mv else 'none'})",
        ]
        if self.mode == "anytime":
            budget = (
                "unlimited (answers are exact)"
                if self.budget is None
                else f"{self.budget} refined windows/query"
            )
            lines.append(
                f"mode: anytime — best-so-far top-k with sound error "
                f"bounds; budget {budget}"
            )
        lines.append("because:")
        lines += [f"  - {r}" for r in self.reasons]
        if self.cascade is not None:
            lines.append(self.cascade.explain())
        return "\n".join(lines)


def plan_search(
    config: SearchConfig,
    n_rows: int,
    n_queries: int,
    *,
    has_index: bool = False,
    has_mesh: bool = False,
    driver: str | None = None,
    cascade: CascadePlan | None = None,
    mode: str = "exact",
    budget: int | None = None,
    anytime_info: dict | None = None,
    channels: int = 1,
) -> Plan:
    """Choose the driver for a query batch against one database session:
    ``mode="anytime"`` (and an exact subsequence query, signalled by
    ``anytime_info["subsequence"]``) routes through the anytime tier,
    which ``anytime_info`` (lengths, windows, clusters) summarizes for
    ``explain()``; otherwise an explicit ``driver`` override wins; then
    the stage-0 index (the most specific prebuilt artifact); then an
    attached mesh (the sharded driver); then ``method="full"`` and
    databases below ``SMALL_DB_ROWS`` rows go to the scan driver, the
    rest to the host driver.  ``channels`` (the session's d) rides the
    plan for ``explain()``."""
    if mode not in ("exact", "anytime"):
        raise ValueError(f"mode={mode!r} unknown; use 'exact' or 'anytime'")
    stages = PIPELINES[config.method]
    because = (
        (
            f"stage order chosen by calibration: method="
            f"{config.method!r} predicts "
            f"{cascade.cost_per_candidate:.2f} sweep units/candidate",
        )
        if cascade is not None
        else ()
    )
    if mode == "anytime" or (anytime_info or {}).get("subsequence"):
        if anytime_info is None:
            raise ValueError(
                "mode='anytime' needs the anytime tier: build the session "
                "with Database.build(..., anytime=True) (or a dict of "
                "tier options)"
            )
        if driver is not None:
            raise ValueError(
                f"driver={driver!r} cannot be combined with the anytime "
                f"tier — the cluster explorer is the driver"
            )
        info = (
            f"{anytime_info.get('windows', '?')} windows in "
            f"{anytime_info.get('clusters', '?')} clusters at lengths "
            f"{anytime_info.get('lengths', '?')}"
        )
        if mode == "anytime":
            return Plan(
                "anytime", ("cluster_lb",) + stages,
                (f"anytime tier: best-first exploration over {info}; "
                 f"cluster bounds from envelope boxes + the Theorem 1 "
                 f"triangle inequality, refinement through the "
                 f"standard stage pipeline",) + because,
                n_queries, config, cascade, mode="anytime", budget=budget,
                channels=channels,
            )
        if budget is not None:
            raise ValueError(
                "budget= only applies to mode='anytime' (exact search "
                "always explores everything)"
            )
        return Plan(
            "subsequence", stages,
            (f"subsequence query (length != whole-row length): exact "
             f"gid-order sweep over the anytime tier's window bank "
             f"({info})",) + because,
            n_queries, config, channels=channels,
        )
    if budget is not None:
        raise ValueError(
            "budget= only applies to mode='anytime' (exact search always "
            "explores everything)"
        )
    if driver is not None:
        if driver in ("anytime", "subsequence"):
            raise ValueError(
                f"driver={driver!r} is not directly selectable: use "
                f"mode='anytime' (or a subsequence-length query) on a "
                f"session built with anytime=True"
            )
        if driver not in DRIVERS:
            raise ValueError(
                f"driver={driver!r} unknown; available: {sorted(DRIVERS)}"
            )
        if driver == "indexed":
            if not has_index:
                raise ValueError(
                    "driver='indexed' but no stage-0 index is built: pass "
                    "index=True to Database.build (or load a bundle saved "
                    "with one)"
                )
            stages = ("lb_tri",) + stages
        if driver == "sharded" and not has_mesh:
            raise ValueError(
                "driver='sharded' but no mesh is attached: call "
                "Database.use_mesh(mesh) first"
            )
        return Plan(driver, stages, ("caller override",) + because,
                    n_queries, config, cascade, channels=channels)
    if has_index:
        return Plan(
            "indexed", ("lb_tri",) + stages,
            ("stage-0 triangle index built for this database: O(R) "
             "arithmetic per candidate kills most lanes before any "
             "envelope work, and the reference distances seed the "
             "top-k exactly",) + because,
            n_queries, config, cascade, channels=channels,
        )
    if has_mesh:
        return Plan(
            "sharded", stages,
            ("mesh attached via Database.use_mesh: the database is "
             "sharded over its devices and per-query best bounds are "
             "pmin-exchanged between block rounds",) + because,
            n_queries, config, cascade, channels=channels,
        )
    if config.method == "full":
        return Plan(
            "scan", stages,
            ("method='full' has no LB stages to compact, so the dense "
             "block scan is the fastest layout",) + because,
            n_queries, config, cascade, channels=channels,
        )
    if n_rows < SMALL_DB_ROWS:
        return Plan(
            "scan", stages,
            (f"database has {n_rows} rows (< {SMALL_DB_ROWS}): one device "
             f"sweep beats host orchestration overhead at this size",) + because,
            n_queries, config, cascade, channels=channels,
        )
    return Plan(
        "host", stages,
        (f"database has {n_rows} rows (>= {SMALL_DB_ROWS}): the host "
         f"driver gathers LB survivors into pooled fixed-size DP "
         f"chunks, so post-LB wall-clock tracks surviving work",) + because,
        n_queries, config, cascade, channels=channels,
    )
