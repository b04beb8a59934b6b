"""Kernel tune-sweep CLI (port of ``repro.launch.tune``).

Runs the deterministic timed sweep over every kernel family's schedule
space at one (block, series-length) shape on one device, prints each
sweep, the winning configs and the measured planner stage costs, and
optionally writes the resulting ``TuneTable`` as JSON.  Every candidate
schedule is checked bit-identical against the fallback before it may
win.  For a single session, ``Database.build(..., tune=True)`` runs the
same sweep and keeps the table in the ``.npz`` bundle.

Usage:
  python -m repro_torch.launch.tune --length 1000 --block 32
  python -m repro_torch.launch.tune --families lb_fused,lb_kim --p 2 \\
      --iters 5 --out tune.json
  python -m repro_torch.launch.tune --device cpu --length 64 --block 16
"""

from __future__ import annotations

import argparse
import math

from repro_torch.kernels.tuning import SESSION_FAMILIES, autotune_session


def _parse_p(s: str):
    return math.inf if s == "inf" else int(s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--length", type=int, default=128,
                    help="series length n to tune at")
    ap.add_argument("--block", type=int, default=64,
                    help="candidate block size b to tune at")
    ap.add_argument("--window", type=int, default=None,
                    help="Sakoe-Chiba half-width (default: length // 10)")
    ap.add_argument("--p", default="1", help="distance power: 1, 2 or inf")
    ap.add_argument("--queries", type=int, default=4,
                    help="query-batch width for the qbatch families")
    ap.add_argument("--iters", type=int, default=3,
                    help="timing repetitions per candidate config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--families", default="",
                    help="comma-separated subset (default: all of "
                    f"{', '.join(SESSION_FAMILIES)})")
    ap.add_argument("--no-costs", action="store_true",
                    help="skip the planner stage-cost measurement")
    ap.add_argument("--out", default="",
                    help="write the tuned TuneTable as JSON to this path")
    ap.add_argument("--device", default=None,
                    help="device to tune on (default: the GPU; 'cpu' runs the "
                    "plain versions)")
    args = ap.parse_args(argv)

    families = tuple(f for f in args.families.split(",") if f) or SESSION_FAMILIES
    unknown = sorted(set(families) - set(SESSION_FAMILIES))
    if unknown:
        ap.error(f"unknown families {unknown}; known: {SESSION_FAMILIES}")

    table = autotune_session(
        n=args.length,
        b=args.block,
        w=args.window if args.window is not None else max(args.length // 10, 1),
        p=_parse_p(args.p),
        families=families,
        nq=args.queries,
        iters=args.iters,
        seed=args.seed,
        device=args.device,
        measure_costs=not args.no_costs,
        verbose=True,
    )

    print("\n# winners (paste-ready for kernels/tuning/defaults.py):")
    for (family, backend, bucket), cfg in sorted(table.entries.items()):
        print(f'    ("{family}", "{backend}", "{bucket}"): '
              f"KernelConfig(tile_b={cfg.tile_b}, lane_chunk={cfg.lane_chunk}, "
              f'depth={cfg.depth}, grid="{cfg.grid}"),')
    if table.stage_costs:
        print("# measured stage costs (sweep units, planner override):")
        for stage, cost in sorted(table.stage_costs.items()):
            print(f"#   {stage}: {cost:.3f}")

    if args.out:
        with open(args.out, "w") as f:
            f.write(table.to_json())
        print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
