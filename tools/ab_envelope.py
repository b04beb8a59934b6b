"""A/B of K1, the envelope kernel, from several source trees on one card.

Each ``--csrc LABEL=DIR`` names a ``csrc`` directory (this checkout's
``src/repro_torch/csrc``, or another checkout's unpacked into the
git-ignored ``build/``).  Its ``envelope.cu`` is compiled alone with
nvcc into ``build/envelope_ab/LABEL/`` and its ``repro_envelope`` entry
loaded.  For each of ``SHAPES`` (rows, length, band; float32 random
walks) the variants run in turns A B ... B A.  Each turn gives the
device time per call (the kernels' self time under torch.profiler over
``ITERS`` calls) and the time per call (CUDA events around as many
back-to-back calls).  Every variant's U and L must equal the plain
version's bits.  One JSON line per shape holds the turns, the bytes
bound (each input read once, U and L written once, at 3.35 TB/s) and the
card's name and power limit.

    git archive <commit> src | tar -x -C build/parent
    python tools/ab_envelope.py --csrc change=src/repro_torch/csrc \\
        --csrc parent=build/parent/src/repro_torch/csrc
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
HBM_BYTES_PER_S = 3.35e12
#: (rows, length, band): the default session's build, its 16 queries and
#: lb_webb's 32-row blocks; the largest batch that runs a block per row
#: and one twice that; the scan session's build (chip_smoke.py phase 4),
#: its 32-row blocks and 8 queries
SHAPES = ((100_000, 1000, 100), (16, 1000, 100), (32, 1000, 100), (256, 1000, 100),
          (512, 1000, 100), (768, 128, 12), (32, 128, 12), (8, 128, 12))
ITERS = 20


def build(label: str, csrc: pathlib.Path):
    """Compile one tree's envelope.cu into a shared library; its entry."""
    from repro_torch.kernels import cuda_lib

    out = ROOT / "build" / "envelope_ab" / label
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libenvelope.so"
    cmd = [cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", str(csrc / "envelope.cu"),
           "-o", str(lib)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}:\n{done.stdout}{done.stderr}")
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.repro_envelope
    fn.restype = _INT
    if not hasattr(cdll, "repro_envelope_workspace"):  # a tree without the long-row path
        fn.argtypes = [_INT, _P, _P, _P, _I64, _INT, _INT, _P]
        return fn
    fn.argtypes = [_INT, _P, _P, _P, _I64, _INT, _INT, _P, _P]
    cdll.repro_envelope_workspace.argtypes = [_INT, _I64, _INT, _INT]
    cdll.repro_envelope_workspace.restype = _I64

    def with_workspace(dtype, x, u, l, rows, n, w, stream):
        import torch

        nbytes = cdll.repro_envelope_workspace(dtype, rows, n, w)
        ws = torch.empty(max(nbytes, 1), dtype=torch.uint8, device="cuda")
        return fn(dtype, x, u, l, rows, n, w, ws.data_ptr() if nbytes else None, stream)

    return with_workspace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", required=True, help="LABEL=DIR")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ab_envelope: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import random_walks
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.envelope.ops import envelope_plain

    variants = {}
    for spec in args.csrc:
        label, _, path = spec.partition("=")
        variants[label] = build(label, (ROOT / path).resolve())
    dev = torch.device("cuda")
    stream = cuda_lib.stream_of(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    labels = list(variants)
    ok = True
    for rows, length, w in SHAPES:
        x = torch.as_tensor(random_walks(np.random.default_rng(0), rows, length),
                            device=dev).float()
        u, l = torch.empty_like(x), torch.empty_like(x)
        want = envelope_plain(x, w)

        def call(fn):
            code = fn(0, x.data_ptr(), u.data_ptr(), l.data_ptr(), rows, length, w, stream)
            if code != 0:
                raise RuntimeError(f"envelope launch failed: error {code}")

        turns = []
        for label in labels + labels[::-1]:
            fn = variants[label]
            u.fill_(float("nan"))
            call(fn)
            torch.cuda.synchronize()
            same = torch.equal(u, want[0]) and torch.equal(l, want[1])
            for _ in range(2):
                call(fn)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ITERS):
                    call(fn)
                torch.cuda.synchronize()
            dev_us = sum(
                (getattr(e, "self_device_time_total", 0)
                 or getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages()
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                call(fn)
            end.record()
            end.synchronize()
            turns.append(dict(label=label, device_ms=dev_us / 1e3 / ITERS,
                              ms=start.elapsed_time(end) / ITERS, bit_equal=same))
            ok = ok and same
        bound = 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        print(json.dumps({"shape": f"{rows} x {length} w={w} float32", "bound_ms": bound,
                          "card": card, "turns": turns}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
