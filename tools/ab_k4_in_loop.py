"""A/B of K4 inside the default search's device-resident loop.

Compares this checkout's K4 (``csrc/lb_fused.cu``, one warp per pair)
with the K4 of another checkout's sources, given by ``--other-csrc``
(PR 13's design: one block per tile of candidate rows, pass 2 one live
row at a time on the whole block), both inside this checkout's
``repro_torch.core.cascade.fused_block_loop``.

The loop takes its K4 launcher from ``lb_fused_prepare``; for the other
variant this script puts in a launcher of the other kernel, built with
nvcc from ``lb_fused.cu`` in ``--other-csrc`` (into the git-ignored
``build/``) at that kernel's default schedule (8 rows per block, grid
"qb").  That kernel has no stage output and reads its bounds as a
contiguous (Q,) array.  So its launcher writes the stage with
``lb_fused_stage_plain`` (a few PyTorch elementwise kernels, reported
apart), and the session must have k = 1, the default, which makes the
loop's bound column contiguous.  Both variants see the same blocks and
the same bounds, because their answers are the same; the script checks
that.

The session is the default one (100,000 random walks of length 1,000
from seed 0, ``SearchConfig()``, 16 queries).  The variants run in the
turns A B B A, each turn a timed search and a profiled one.  One JSON
line gives per turn the search wall, K4's device time and count, the
device time of everything else by kernel, and whether the indices and
distance bits equal the first turn's; then the card's name and power
limit.  The other variant's wall includes its stage kernels and their
launches, so only the K4 device times compare like for like.

    git archive <commit> src | tar -x -C build/other
    python tools/ab_k4_in_loop.py --other-csrc build/other/src/repro_torch/csrc
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

# the other kernel's entry: dtype, p, cands, qs, upper, lower, bounds, nq,
# nb, n, w, tile_b, grid_bq, lb1, lb, stream
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
OTHER_SIGNATURE = [_INT, _INT, _P, _P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT,
                   _P, _P, _P]
OTHER_TILE_B = 8


def build_other(csrc: pathlib.Path):
    """Compile the other checkout's lb_fused.cu alone and load its entry."""
    from repro_torch.kernels import cuda_lib

    out = ROOT / "build" / "k4_other"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_lib.find_nvcc()
    obj, lib = out / "lb_fused.o", out / "libk4_other.so"
    for cmd in ([nvcc, *cuda_lib.NVCC_FLAGS, "-c", str(csrc / "lb_fused.cu"), "-o", str(obj)],
                [nvcc, "-shared", str(obj), "-o", str(lib)]):
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode:
            raise SystemExit(f"{' '.join(cmd)} failed:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(str(lib)).repro_lb_fused
    fn.restype, fn.argtypes = ctypes.c_int, OTHER_SIGNATURE
    return fn


def other_prepare(fn):
    """An ``lb_fused_prepare`` for the loop that launches the other K4."""
    import torch

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.common import kernel_dtype, p_code
    from repro_torch.kernels.lb_fused.ops import lb_fused_stage_plain

    def prepare(qs, upper, lower, w, bounds, p, block, stage):
        if bounds.stride(0) != 1:
            raise SystemExit("the other K4 reads contiguous bounds: the session needs k = 1")
        nq, n = qs.shape
        lb1 = torch.empty((nq, block), dtype=qs.dtype, device=qs.device)
        lb = torch.empty_like(lb1)
        head = (kernel_dtype(qs), p_code(p))
        tail = (qs.data_ptr(), upper.data_ptr(), lower.data_ptr(), bounds.data_ptr(), nq,
                block, n, w, OTHER_TILE_B, 0, lb1.data_ptr(), lb.data_ptr(),
                cuda_lib.stream_of(qs.device))

        def run(cands, real=block):
            cuda_lib.check("lb_fused (other)", fn(*head, cands.data_ptr(), *tail))
            stage.copy_(lb_fused_stage_plain(lb1, lb, bounds, real))
            return lb1, lb

        return run

    return prepare


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other-csrc", required=True,
                    help="csrc directory holding the other checkout's lb_fused.cu")
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

    variants = {"this": cascade.lb_fused_prepare,
                "other": other_prepare(build_other(pathlib.Path(args.other_csrc)))}
    rng = np.random.default_rng(0)
    db = Database.build(random_walks(rng, 100_000, 1000))
    queries = random_walks(rng, 16, 1000)
    first, turns = None, []
    for name in ("this", "other", "other", "this"):
        cascade.lb_fused_prepare = variants[name]
        db.search(queries[:1])  # first use of the variant
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.searches):
            t0 = time.perf_counter()
            res = db.search(queries)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            db.search(queries)
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            by_kernel[e.key] = (us / 1e3, e.count)
        k4 = [v for key, v in by_kernel.items() if "lb_fused_kernel" in key]
        if first is None:
            first = res
        turns.append({
            "variant": name, "search_s": walls,
            "k4_device_ms": sum(ms for ms, _ in k4), "k4_launches": sum(c for _, c in k4),
            "busy_ms": sum(ms for ms, _ in by_kernel.values()),
            "other_kernels": {key: v for key, v in by_kernel.items()
                              if "lb_fused_kernel" not in key},
            "same_indices": bool(np.array_equal(res.indices, first.indices)),
            "same_distance_bits": res.distances.tobytes() == first.distances.tobytes(),
        })
    cascade.lb_fused_prepare = variants["this"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "turns": turns}), flush=True)
    return 0 if all(t["same_indices"] and t["same_distance_bits"] for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main())
