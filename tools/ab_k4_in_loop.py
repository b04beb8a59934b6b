"""A/B of K4 inside the default session's device-resident loop.

Each ``--csrc LABEL=DIR`` names a ``csrc`` directory (this checkout's
``src/repro_torch/csrc``, or another checkout's unpacked into the
git-ignored ``build/``).  Its ``lb_fused.cu`` is compiled alone with nvcc
into ``build/k4_in_loop/LABEL/`` and put into this checkout's
``repro_torch.core.cascade.fused_block_loop`` in place of
``lb_fused_prepare``'s launcher, at the same schedule (the active tune
table's).  A tree whose ``repro_lb_fused`` takes the queries' LB_Kim
features (its source names ``qfeat``) also runs the ``kim_improved``
loop (K4's kim entry, the features from this checkout's K6); an older
tree runs the default loop only.

The session is the default one (100,000 random walks of length 1,000
from seed 0, ``SearchConfig()``, 16 queries).  The trees run in turns
A B ... B A, each turn ``--searches`` timed searches and a profiled one
per method.  One JSON line per turn gives the search walls, K4's device
time and launches, the busy time, and whether the indices and distance
bits equal the first turn's default search; then one line with the
card's name and power limit.

    git archive <commit> src | tar -x -C build/parent
    python tools/ab_k4_in_loop.py --csrc parent=build/parent/src/repro_torch/csrc \\
        --csrc change=src/repro_torch/csrc
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def build(label: str, csrc: pathlib.Path):
    """Compile one tree's lb_fused.cu alone; (its entry, whether it takes
    the queries' LB_Kim features)."""
    from repro_torch.kernels import cuda_lib

    out = ROOT / "build" / "k4_in_loop" / label
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libk4.so"
    cmd = [cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", str(csrc / "lb_fused.cu"),
           "-o", str(lib)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {csrc}:\n{done.stdout}{done.stderr}")
    kim = "qfeat" in (csrc / "lb_fused.cu").read_text()
    fn = ctypes.CDLL(str(lib)).repro_lb_fused
    fn.restype = _INT
    fn.argtypes = ([_INT, _INT, _P, _P, _P, _P, _P, _I64] + ([_P] if kim else [])
                   + [_I64, _I64, _INT, _INT, _INT, _INT, _I64, _P, _P, _P, _P, _P])
    return fn, kim


def tree_prepare(fn, takes_kim: bool):
    """An ``lb_fused_prepare`` for the loop that launches the tree's K4."""
    import torch

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.common import kernel_dtype, p_code
    from repro_torch.kernels.lb_fused.ops import _check_bounds, _schedule
    from repro_torch.kernels.lb_kim.ops import lb_kim_features_launch

    def prepare(qs, upper, lower, w, bounds, p, block, stage=None, kim=False):
        if kim and not takes_kim:
            raise SystemExit("this tree's K4 has no kim entry")
        nq, n = qs.shape
        w = int(min(w, n - 1))
        tile_b, grid = _schedule(block, n, w, qs.element_size(), None, None, None)
        lb1 = torch.empty((nq, block), dtype=qs.dtype, device=qs.device)
        lb = torch.empty_like(lb1)
        ws = cuda_lib.workspace("lb_fused", qs.device, kernel_dtype(qs), nq, block, n, w,
                                tile_b, int(grid == "bq"))
        qfeat = lb_kim_features_launch(qs) if kim else None
        head = (kernel_dtype(qs), p_code(p))
        mid = ((qs.data_ptr(), upper.data_ptr(), lower.data_ptr(), bounds.data_ptr(),
                _check_bounds(bounds, qs.device, qs.dtype, nq))
               + ((cuda_lib.ptr(qfeat),) if takes_kim else ())
               + (nq, block, n, w, tile_b, int(grid == "bq")))
        tail = (lb1.data_ptr(), lb.data_ptr(), cuda_lib.ptr(stage), cuda_lib.ptr(ws),
                cuda_lib.stream_of(qs.device))

        def run(cands, real=block):
            cuda_lib.check("lb_fused (tree)", fn(*head, cands.data_ptr(), *mid, int(real),
                                                 *tail))
            return lb1, lb

        run.tensors = (qs, upper, lower, bounds, stage, lb1, lb, ws, qfeat)
        return run

    return prepare


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", required=True, help="LABEL=DIR")
    ap.add_argument("--searches", type=int, default=2, help="timed searches per turn")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ab_k4_in_loop: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.api import Database
    from repro_torch.core import cascade
    from repro_torch.data.synthetic import random_walks

    own = cascade.lb_fused_prepare
    trees = {}
    for spec in args.csrc:
        label, _, path = spec.partition("=")
        trees[label] = build(label, (ROOT / path).resolve())
    rng = np.random.default_rng(0)
    db = Database.build(random_walks(rng, 100_000, 1000))
    queries = random_walks(rng, 16, 1000)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    labels = list(trees)
    first, ok = None, True
    for label in labels + labels[::-1]:
        fn, takes_kim = trees[label]
        cascade.lb_fused_prepare = tree_prepare(fn, takes_kim)
        turn = {"tree": label}
        for method in ("lb_improved", "kim_improved") if takes_kim else ("lb_improved",):
            db.search(queries[:1], method=method)  # first use
            torch.cuda.synchronize()
            walls = []
            for _ in range(args.searches):
                t0 = time.perf_counter()
                res = db.search(queries, method=method)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                db.search(queries, method=method)
                torch.cuda.synchronize()
            by_kernel = {}
            for e in prof.key_averages():
                if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                    continue
                us = (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
                by_kernel[e.key] = (us / 1e3, e.count)
            k4 = [v for key, v in by_kernel.items() if "lb_fused_kernel" in key]
            first = first or res
            same = (bool(np.array_equal(res.indices, first.indices))
                    and res.distances.tobytes() == first.distances.tobytes())
            ok = ok and same
            turn[method] = {
                "search_s": walls, "k4_device_ms": sum(ms for ms, _ in k4),
                "k4_launches": sum(c for _, c in k4),
                "busy_ms": sum(ms for ms, _ in by_kernel.values()),
                "full_dtw": res.stats.full_dtw, "same_answers_as_first": same,
            }
        print(json.dumps(turn), flush=True)
    cascade.lb_fused_prepare = own
    print(json.dumps({"card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
