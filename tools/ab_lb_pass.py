"""A/B of K2 (LB_Keogh and H, with K7, its stream entry), K3 (LB_Improved
pass 2) and K6 (LB_Kim) from several source trees on one card.

Each ``--csrc LABEL=DIR`` names a ``csrc`` directory (this checkout's
``src/repro_torch/csrc``, or another checkout's unpacked into the
git-ignored ``build/``).  Its ``lb_keogh.cu``, ``lb_improved.cu`` and
``lb_kim.cu`` are compiled with nvcc into ``build/lb_pass_ab/LABEL/`` and
their entries loaded (a tree whose K3 takes a workspace pointer is
recognised by its ``repro_lb_improved_pass2_workspace`` entry, one whose
K6 takes a feature workspace and a ticket by its
``repro_lb_kim_features`` entry).

Checks: at each of ``CHECKS`` (the shapes ``chip_smoke.py`` phase 2 holds
K2 and K3 to, and Q=16, B=1,024) every tree's K2 lb and H, K7 lb and H,
K3 lb2 and K6 lb (with an entry mask) must equal the first tree's bit for
bit.  Times: at each of ``TIMED`` the trees run in turns A B ... B A;
each turn gives the device time per call (the kernels' self time under
torch.profiler over ``ITERS`` calls) and the time per call (CUDA events
around as many back-to-back calls).  One JSON line per check and per
timed shape, with the bytes bound (each input read once, each output
written once, at 3.35 TB/s) and the card's name and power limit.

    git archive <commit> src | tar -x -C build/parent
    python tools/ab_lb_pass.py --csrc parent=build/parent/src/repro_torch/csrc \\
        --csrc change=src/repro_torch/csrc
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
HBM_BYTES_PER_S = 3.35e12
ITERS = 20
#: (label, dtype, Q, B, n, w, p, pairs): K2 on a dense (Q, B) grid (and on
#: ``pairs`` random pairs), K7 on B windows of a segment at hop 1 and 3,
#: K3 on K2's H with band w (and on ``pairs`` random rows)
CHECKS = (
    ("main", "float32", 16, 32, 1000, 100, 1, 37),
    ("main", "float32", 16, 32, 1000, 100, 2, 37),
    ("main", "float32", 16, 32, 1000, 100, math.inf, 41),
    ("w=0", "float32", 16, 32, 1000, 0, 2, 0),
    ("w=500", "float32", 16, 32, 1000, 500, 2, 0),
    ("w=n-1", "float32", 16, 32, 1000, 999, 2, 0),
    ("ragged", "float64", 3, 7, 50, 4, 2, 0),
    ("float64", "float64", 3, 5, 80, 8, 1, 0),
    ("B=1024", "float32", 16, 1024, 1000, 100, 1, 0),
    ("long, parent's largest", "float32", 2, 3, 4000, 3999, 1, 0),
)
#: (label, Q, B, n, w, hop): float32, p = 1; hop 0 times K2 and K3 on a
#: (B, n) batch, hop > 0 times K7 on the windows of a segment
TIMED = (
    ("K2/K3 Q=16 B=32", 16, 32, 1000, 100, 0),
    ("K2/K3 Q=16 B=1024", 16, 1024, 1000, 100, 0),
    ("K7 Q=16 B=32 hop=1", 16, 32, 1000, 100, 1),
    ("K7 Q=16 B=1024 hop=8", 16, 1024, 1000, 100, 8),
)


def build(label: str, csrc: pathlib.Path):
    """Compile one tree's K2 and K3 into a shared library; its entries."""
    from repro_torch.kernels import cuda_lib

    out = ROOT / "build" / "lb_pass_ab" / label
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "liblbpass.so"
    cmd = [cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
           str(csrc / "lb_keogh.cu"), str(csrc / "lb_improved.cu"), str(csrc / "lb_kim.cu"),
           "-o", str(lib)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}:\n{done.stdout}{done.stderr}")
    cdll = ctypes.CDLL(str(lib))
    cdll.repro_lb_keogh.argtypes = [_INT, _INT, _P, _P, _P, _P, _P, _I64, _I64, _INT, _INT,
                                    _P, _P, _P]
    cdll.repro_lb_keogh_stream.argtypes = [_INT, _INT, _P, _P, _P, _I64, _I64, _I64, _INT,
                                           _INT, _P, _P, _P]
    pass2 = [_INT, _INT, _P, _P, _P, _I64, _I64, _INT, _INT, _P]
    ws = hasattr(cdll, "repro_lb_improved_pass2_workspace")
    cdll.repro_lb_improved_pass2.argtypes = pass2 + ([_P, _P] if ws else [_P])
    if ws:
        cdll.repro_lb_improved_pass2_workspace.argtypes = [_INT, _I64, _INT, _INT]
        cdll.repro_lb_improved_pass2_workspace.restype = _I64
    kim_ws = hasattr(cdll, "repro_lb_kim_features")
    cdll.repro_lb_kim.argtypes = ([_INT, _INT, _P, _P, _P, _I64, _I64, _INT, _INT]
                                  + ([_P, _P] if kim_ws else []) + [_P, _P])
    for fn in (cdll.repro_lb_keogh, cdll.repro_lb_keogh_stream, cdll.repro_lb_improved_pass2,
               cdll.repro_lb_kim):
        fn.restype = _INT
    return cdll, ws, kim_ws


class Tree:
    """One tree's K2, K7 and K3 as calls on torch tensors."""

    def __init__(self, label, csrc):
        self.label = label
        self.lib, self.has_ws, self.kim_ws = build(label, csrc)
        self.ticket = None

    def _check(self, name, code):
        if code != 0:
            raise RuntimeError(f"{self.label}: {name} failed to launch: error {code}")

    def keogh(self, cands, u, l, p, qi=None, ci=None, out=None):
        import torch

        from repro_torch.kernels import cuda_lib
        from repro_torch.kernels.common import kernel_dtype, p_code

        nq, n = u.shape
        lead = (nq, cands.shape[0]) if qi is None else (qi.shape[0],)
        lb, h = out if out else (torch.empty(lead, dtype=cands.dtype, device=cands.device),
                                 torch.empty(lead + (n,), dtype=cands.dtype,
                                             device=cands.device))
        npairs = lb.numel()
        self._check("lb_keogh", self.lib.repro_lb_keogh(
            kernel_dtype(cands), p_code(p), cands.data_ptr(), u.data_ptr(), l.data_ptr(),
            cuda_lib.ptr(qi), cuda_lib.ptr(ci), npairs, cands.shape[0], n, 8,
            lb.data_ptr(), h.data_ptr(), cuda_lib.stream_of(cands.device)))
        return lb, h

    def stream(self, seg, u, l, n, hop, nb, p, out=None):
        import torch

        from repro_torch.kernels import cuda_lib
        from repro_torch.kernels.common import kernel_dtype, p_code

        nq = u.shape[0]
        lb, h = out if out else (torch.empty((nq, nb), dtype=seg.dtype, device=seg.device),
                                 torch.empty((nq, nb, n), dtype=seg.dtype, device=seg.device))
        self._check("lb_keogh_stream", self.lib.repro_lb_keogh_stream(
            kernel_dtype(seg), p_code(p), seg.data_ptr(), u.data_ptr(), l.data_ptr(), nq, nb,
            hop, n, 8, lb.data_ptr(), h.data_ptr(), cuda_lib.stream_of(seg.device)))
        return lb, h

    def pass2(self, h, qs, w, p, qi=None, out=None):
        import torch

        from repro_torch.kernels import cuda_lib
        from repro_torch.kernels.common import kernel_dtype, p_code

        n = h.shape[-1]
        rows = h.numel() // n
        lead = h.shape[:-1]
        lb2 = out if out is not None else torch.empty(lead, dtype=h.dtype, device=h.device)
        bstride = h.shape[1] if qi is None else 1
        args = [kernel_dtype(h), p_code(p), h.data_ptr(), qs.data_ptr(), cuda_lib.ptr(qi),
                rows, bstride, n, w, lb2.data_ptr()]
        if self.has_ws:
            nbytes = self.lib.repro_lb_improved_pass2_workspace(kernel_dtype(h), rows, n, w)
            ws = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=h.device)
            args.append(ws.data_ptr() if nbytes else None)
        self._check("lb_improved_pass2",
                    self.lib.repro_lb_improved_pass2(*args, cuda_lib.stream_of(h.device)))
        return lb2


    def kim(self, cands, qs, p, mask=None, out=None):
        import torch

        from repro_torch.kernels import cuda_lib
        from repro_torch.kernels.common import kernel_dtype, p_code

        nq, nb, n = qs.shape[0], cands.shape[0], cands.shape[1]
        lb = out if out is not None else torch.empty((nq, nb), dtype=cands.dtype,
                                                     device=cands.device)
        args = [kernel_dtype(cands), p_code(p), cands.data_ptr(), qs.data_ptr(),
                cuda_lib.ptr(mask), nq, nb, n, 8]
        if self.kim_ws:
            if self.ticket is None:
                self.ticket = torch.zeros(1, dtype=torch.int64, device=cands.device)
            feats = torch.empty((nb + nq, 4), dtype=cands.dtype, device=cands.device)
            args += [feats.data_ptr(), self.ticket.data_ptr()]
        self._check("lb_kim", self.lib.repro_lb_kim(*args, lb.data_ptr(),
                                                    cuda_lib.stream_of(cands.device)))
        return lb


def timed(fn):
    """(device ms, ms) per call of fn: profiler self time and CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    dev_us = sum((getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return dev_us / 1e3 / ITERS, start.elapsed_time(end) / ITERS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", required=True, help="LABEL=DIR")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_lb_pass: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import random_walks
    from repro_torch.kernels.envelope.ops import envelope_plain

    trees = []
    for spec in args.csrc:
        label, _, path = spec.partition("=")
        trees.append(Tree(label, (ROOT / path).resolve()))
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)

    def walks(count, n, dtype):
        return torch.as_tensor(random_walks(rng, count, n), device=dev).to(
            getattr(torch, dtype)).contiguous()

    ok = True
    for label, dtype, nq, nb, n, w, p, pairs in CHECKS:
        qs, cands = walks(nq, n, dtype), walks(nb, n, dtype)
        u, l = (t.contiguous() for t in envelope_plain(qs, max(w, 1)))
        seg = walks(1, (nb - 1) * 3 + n, dtype)[0]
        mask = torch.as_tensor(rng.random((nq, nb)) < 0.6, device=dev)
        qi = torch.as_tensor(rng.integers(0, nq, pairs), device=dev) if pairs else None
        ci = torch.as_tensor(rng.integers(0, nb, pairs), device=dev) if pairs else None
        outs = []
        for tree in trees:
            lb, h = tree.keogh(cands, u, l, p)
            got = {"K2 lb": lb, "K2 H": h, "K3": tree.pass2(h, qs, w, p),
                   "K6": tree.kim(cands, qs, p), "K6 masked": tree.kim(cands, qs, p, mask)}
            for hop in (1, 3):
                slb, sh = tree.stream(seg, u, l, n, hop, (seg.numel() - n) // hop + 1, p)
                got[f"K7 hop={hop} lb"], got[f"K7 hop={hop} H"] = slb, sh
            if qi is not None:
                plb, ph = tree.keogh(cands, u, l, p, qi, ci)
                got["K2 pairs lb"], got["K2 pairs H"] = plb, ph
                got["K3 pairs"] = tree.pass2(ph, qs, w, p, qi)
            outs.append(got)
        torch.cuda.synchronize()
        same = {tree.label: all(torch.equal(outs[0][k], o[k]) for k in o)
                for tree, o in zip(trees, outs)}
        ok = ok and all(same.values())
        print(json.dumps({"check": label, "dtype": dtype, "Q": nq, "B": nb, "n": n, "w": w,
                          "p": str(p), "pairs": pairs, "bit_equal_to_" + trees[0].label: same,
                          "card": card}), flush=True)

    for label, nq, nb, n, w, hop in TIMED:
        qs, cands = walks(nq, n, "float32"), walks(nb, n, "float32")
        u, l = (t.contiguous() for t in envelope_plain(qs, w))
        seg = walks(1, (nb - 1) * max(hop, 1) + n, "float32")[0]
        lb = torch.empty((nq, nb), device=dev)
        h = torch.empty((nq, nb, n), device=dev)
        lb2 = torch.empty((nq, nb), device=dev)
        lbk = torch.empty((nq, nb), device=dev)
        turns = []
        for tree in trees + trees[::-1]:
            if hop:
                calls = {"K7": lambda t=tree: t.stream(seg, u, l, n, hop, nb, 1, (lb, h))}
            else:
                tree.keogh(cands, u, l, 1, out=(lb, h))
                calls = {"K2": lambda t=tree: t.keogh(cands, u, l, 1, out=(lb, h)),
                         "K3": lambda t=tree: t.pass2(h, qs, w, 1, out=lb2),
                         "K6": lambda t=tree: t.kim(cands, qs, 1, out=lbk)}
            turn = {"label": tree.label}
            for name, fn in calls.items():
                turn[f"{name} device_ms"], turn[f"{name} ms"] = timed(fn)
            turns.append(turn)
        rows = nq * nb
        read = seg.numel() if hop else nb * n
        bound = {"K2 or K7 bound_ms": 4 * (read + 2 * nq * n + rows + rows * n)
                 / HBM_BYTES_PER_S * 1e3}
        if not hop:
            bound["K3 bound_ms"] = 4 * (rows * n + nq * n + rows) / HBM_BYTES_PER_S * 1e3
            bound["K6 bound_ms"] = 4 * (nb * n + nq * n + rows) / HBM_BYTES_PER_S * 1e3
        print(json.dumps({"timed": label, "n": n, "w": w, "hop": hop, **bound, "card": card,
                          "turns": turns}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
