"""Deterministic timed sweep over a kernel family's schedule space (port
of ``repro.kernels.tuning.autotune``).

``autotune(family, ...)`` runs every :func:`search_space` config on
inputs made from one seed at the requested shape, on the session's
device, and returns the fastest config whose outputs are **bit-identical**
to the fallback config's; any other config is discarded.  A config that
cannot launch at the shape (for example a K4 tile whose shared memory
exceeds the card's 227 KB) is recorded as not runnable, not raised.
Rules as in the reference: the fallback first, min-of-iters timing after
a warmup (which includes the kernels' first-use build), ties broken by
position in the space.  On the card each timed call sits between two
``torch.cuda.synchronize()``.

``measure_stage_costs`` times the port's own stage forms, as the
pipeline runs them on the device, in the reference's unit: one
elementwise |c - q| reduction sweep over a candidate row.
``autotune_session`` is what ``Database.build(tune=...)`` calls.

The kernel ops are imported lazily: they import ``tuning.table`` when
they load.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.kernels.common import NotRunnable, resolve_device
from repro_torch.kernels.tuning.space import KernelConfig, search_space, shape_bucket
from repro_torch.kernels.tuning.table import TuneTable

#: families ``autotune_session`` sweeps by default (the reference's)
SESSION_FAMILIES = (
    "envelope",
    "lb_kim",
    "lb_keogh",
    "lb_improved",
    "lb_fused",
    "dtw",
    "pipeline",
)


@dataclasses.dataclass(frozen=True)
class SweepEntry:
    """One config of a sweep: ``seconds`` is the min over iters (inf when
    discarded), ``identical`` the bit-identity verdict against the
    fallback, ``runnable`` False where the config cannot launch here."""

    config: KernelConfig
    seconds: float
    identical: bool
    runnable: bool = True


@dataclasses.dataclass(frozen=True)
class SweepResult:
    family: str
    bucket: str
    best: KernelConfig
    entries: tuple[SweepEntry, ...]

    def explain(self) -> str:
        lines = [f"autotune {self.family} @ {self.bucket}:"]
        for e in self.entries:
            mark = "->" if e.config == self.best else "  "
            if not e.runnable:
                flag = "  NOT RUNNABLE at this shape"
            elif not e.identical:
                flag = "  DISCARDED (not bit-identical)"
            else:
                flag = ""
            lines.append(f"{mark} {e.config.to_dict()}  {e.seconds * 1e6:9.1f} us{flag}")
        return "\n".join(lines)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, iters: int, device: torch.device) -> float:
    fn()  # warmup: the first call builds the kernels
    _sync(device)
    best = math.inf
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _as_host(out) -> tuple[torch.Tensor, ...]:
    if not isinstance(out, tuple):
        out = (out,)
    return tuple(torch.as_tensor(o).cpu() for o in out)


def _walks(rng, rows, n, device):
    x = rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)
    return torch.as_tensor(x, device=device)


def _family_runner(family, b, n, w, p, nq, seed, device):
    """(config -> outputs on the host) for one family's sweep.  Inputs
    are made once from ``seed``, so every config sees the same bytes.
    Kernel families run at p in {1, 2} (p = inf runs at 1), as in the
    reference: the schedule does not depend on the norm."""
    from repro_torch.kernels.envelope.ops import envelope_op

    rng = np.random.default_rng(seed)
    kp = p if p in (1, 2) else 1
    cands = _walks(rng, b, n, device)
    qs = _walks(rng, nq, n, device)
    u, l = envelope_op(qs, w)

    if family == "envelope":
        return lambda c: _as_host(envelope_op(cands, w))
    if family == "lb_kim":
        from repro_torch.kernels.lb_kim.ops import lb_kim_qbatch_op

        return lambda c: _as_host(lb_kim_qbatch_op(cands, qs, p=kp, tile_b=c.tile_b))
    if family == "lb_keogh":
        from repro_torch.kernels.lb_keogh.ops import lb_keogh_qbatch_op

        return lambda c: _as_host(lb_keogh_qbatch_op(cands, u, l, kp, tile_b=c.tile_b))
    if family == "lb_improved":
        from repro_torch.kernels.lb_improved.ops import lb_improved_qbatch_op

        return lambda c: _as_host(lb_improved_qbatch_op(cands, qs, u, l, w, kp))
    if family == "lb_fused":
        from repro_torch.core import lb as lb_mod
        from repro_torch.kernels.lb_fused.ops import lb_fused_qbatch_op

        lb1 = lb_mod.lb_keogh_powered_qbatch(cands, u, l, kp).cpu().numpy()
        # a mid-quantile bound sends about half the lanes into pass 2
        bounds = torch.as_tensor(
            np.quantile(lb1, 0.5, axis=1).astype(np.float32), device=device
        )
        return lambda c: _as_host(lb_fused_qbatch_op(
            cands, qs, u, l, w, bounds, kp, tile_b=c.tile_b, depth=c.depth, grid=c.grid,
        ))
    if family == "dtw":
        from repro_torch.kernels.dtw.ops import dtw_pairs_op, dtw_qbatch_op

        q0 = qs[:1]
        true = dtw_qbatch_op(q0, cands, w, kp)[0].cpu().numpy()
        # bounds straddling the true distances: some lanes abandon
        fracs = np.resize([0.3, 0.8, 1.2], b)
        bounds = torch.as_tensor((true * fracs).astype(np.float32), device=device)
        qi = torch.zeros(b, dtype=torch.int64, device=device)
        ci = torch.arange(b, device=device)
        return lambda c: _as_host(dtw_pairs_op(q0, cands, qi, ci, w, kp, bounds))
    if family == "pipeline":
        from repro_torch.core import lb as lb_mod
        from repro_torch.core.pipeline import run_block_stages

        lbq = lb_mod.lb_keogh_powered_qbatch(cands, u, l, p).cpu().numpy()
        bound = torch.as_tensor(
            np.quantile(lbq, 0.4, axis=1).astype(np.float32), device=device
        )
        mask0 = torch.ones((nq, b), dtype=torch.bool, device=device)

        def run(c):
            st = run_block_stages(
                qs, u, l, w, p, "lb_improved", cands, bound, mask0,
                lane_chunk=c.lane_chunk,
            )
            # dp_lane_work is chunk-padded by definition, so it is the
            # one field that legitimately varies with lane_chunk
            return _as_host((st.d, *st.masks, torch.tensor(st.dp_lane_useful)))

        return run
    raise ValueError(f"no autotune runner for family {family!r}")


def autotune(
    family: str, *, b: int = 64, n: int = 128, w: int | None = None, p=1,
    nq: int = 4, iters: int = 3, seed: int = 0, device=None,
) -> SweepResult:
    """Sweep one family's schedule space at shape ``(b, n)`` on ``device``
    (default: the GPU); returns the fastest bit-identical config."""
    dev = resolve_device(device)
    w = max(n // 10 if w is None else int(w), 1)
    w = min(w, n - 1)
    runner = _family_runner(family, b, n, w, p, nq, seed, dev)
    space = search_space(family)
    reference = runner(space[0])
    entries = []
    for cfg in space:
        try:
            out = runner(cfg)
        except NotRunnable:
            entries.append(SweepEntry(cfg, math.inf, False, runnable=False))
            continue
        identical = len(out) == len(reference) and all(
            torch.equal(a, r) for a, r in zip(out, reference)
        )
        secs = _time(lambda cfg=cfg: runner(cfg), iters, dev) if identical else math.inf
        entries.append(SweepEntry(cfg, secs, identical))
    best = min(range(len(entries)), key=lambda i: (entries[i].seconds, i))
    return SweepResult(family, shape_bucket(b, n), entries[best].config, tuple(entries))


def measure_stage_costs(
    *, b: int = 64, n: int = 128, w: int | None = None, p=1, nq: int = 4,
    iters: int = 3, seed: int = 0, device=None,
) -> dict[str, float]:
    """Per-candidate cost of every cascade stage, in O(n)-sweep units.

    Each stage runs its dense form from ``core.pipeline.STAGES`` (the
    kernels on the card) over ``nq`` queries and ``b`` candidates; the
    unit is the measured time of one elementwise |c - q| reduction over a
    candidate row, so the result drops into ``choose_cascade(unit_costs=...)``.
    ``"full"`` (the banded DP) is measured too.
    """
    from repro_torch.core import pipeline as pipe
    from repro_torch.kernels.envelope.ops import envelope_op

    dev = resolve_device(device)
    w = max(n // 10 if w is None else int(w), 1)
    w = min(w, n - 1)
    rng = np.random.default_rng(seed)
    cands = _walks(rng, b, n, dev)
    qs = _walks(rng, nq, n, dev)
    u, l = envelope_op(qs, w)
    ctx = pipe.make_context(qs, u, l, w, p, "kim_webb")

    t_sweep = _time(
        lambda: torch.sum(torch.abs(cands - qs[0][None, :]), dim=1), iters, dev
    ) / b  # per row
    costs = {}
    for name in ("lb_kim", "lb_keogh", "lb_improved", "lb_webb", "full"):
        stage = pipe.STAGES[name]
        t = _time(lambda stage=stage: stage.dense(ctx, cands), iters, dev) / (nq * b)
        costs[name] = max(t / max(t_sweep, 1e-12), 1e-3)
    return costs


def autotune_session(
    *, n: int, b: int, w: int, p, families=SESSION_FAMILIES, nq: int = 4,
    iters: int = 3, seed: int = 0, device=None, measure_costs: bool = True,
    verbose: bool = False,
) -> TuneTable:
    """One session's sweep: every family at the session's (block, length)
    shape on ``device``, recorded under that shape bucket and as the
    backend's wildcard, plus the measured planner stage costs.  The
    backend key is the device type."""
    dev = resolve_device(device)
    table = TuneTable()
    for family in families:
        res = autotune(
            family, b=b, n=n, w=w, p=p, nq=nq, iters=iters, seed=seed, device=dev
        )
        if verbose:
            print(res.explain(), flush=True)
        table.set(family, res.best, bucket=res.bucket, backend=dev.type)
        table.set(family, res.best, bucket="*", backend=dev.type)
    if measure_costs:
        table.stage_costs = measure_stage_costs(
            b=min(b, 64), n=n, w=w, p=p, nq=nq, iters=iters, seed=seed, device=dev
        )
    return table
