"""Build and load the CUDA kernels of ``repro_torch/csrc`` (ctypes binding).

The sources are compiled with ``nvcc`` at first use, one ``nvcc -c`` per
source started together, then linked into one shared library with a
plain C interface.  The library lands in ``repro_torch/_build/<hash>/``,
keyed by the hash of the sources and flags, so an edited source is never
served by a stale build.  Nothing is built or loaded at import time; a
missing toolkit or a failed compile raises ``RuntimeError`` with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int

#: C signatures: every entry returns cudaGetLastError() as an int.
SIGNATURES = {
    # dtype, x, u, l, rows, n, w, workspace, stream
    "repro_envelope": [_INT, _P, _P, _P, _I64, _INT, _INT, _P, _P],
    # dtype, p, cands, upper, lower, qidx, cidx, npairs, bstride, n, warps, lb, h, stream
    "repro_lb_keogh": [_INT, _INT, _P, _P, _P, _P, _P, _I64, _I64, _INT, _INT, _P, _P, _P],
    # dtype, p, segment, upper, lower, nq, nb, hop, n, warps, lb, h, stream
    "repro_lb_keogh_stream": [_INT, _INT, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P, _P, _P],
    # dtype, p, segment, cstride, upper, lower, nq, nb, hop, n, d, warps, lb, h, stream
    "repro_lb_keogh_stream_mv": [_INT, _INT, _P, _I64, _P, _P, _I64, _I64, _I64, _INT, _INT,
                                 _INT, _P, _P, _P],
    # dtype, p, h, qs, qidx, rows, bstride, n, w, lb2, workspace, stream
    "repro_lb_improved_pass2": [_INT, _INT, _P, _P, _P, _I64, _I64, _INT, _INT, _P, _P, _P],
    # dtype, p, cands, qs, upper, lower, bounds, bound_stride, qfeat, nq, nb, n, w,
    # tile_b, grid_bq, real, lb1, lb, stage, workspace, stream
    "repro_lb_fused": [_INT, _INT, _P, _P, _P, _P, _P, _I64, _P, _I64, _I64, _INT, _INT,
                       _INT, _INT, _I64, _P, _P, _P, _P, _P],
    # dtype, p, cands, qs, mask, nq, nb, n, warps, feats, ticket, lb, stream
    "repro_lb_kim": [_INT, _INT, _P, _P, _P, _I64, _I64, _INT, _INT, _P, _P, _P, _P],
    # dtype, rows, nrows, n, warps, feats, stream
    "repro_lb_kim_features": [_INT, _P, _I64, _INT, _INT, _P, _P],
    # dtype, p, qs, cands, qidx, cidx, bounds, npairs, bstride, n, w, d, out,
    # workspace, stream
    "repro_dtw": [_INT, _INT, _P, _P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _P, _P,
                  _P],
    # dtype, p, qs, cands, stage, bounds, bound_stride, nq, nb, n, w, d, out,
    # top_v, top_i, k, lo, dtw_chunk, n_lb, counts, totals, workspace, stream
    "repro_dtw_masked": [_INT, _INT, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _INT,
                         _P, _P, _P, _INT, _I64, _INT, _INT, _P, _P, _P, _P],
    # dtype, top_v, top_i, k, stage, dvals, nq, nb, lo, dtw_chunk, n_lb, counts, totals,
    # stream
    "repro_block_merge": [_INT, _P, _P, _INT, _P, _P, _I64, _I64, _I64, _INT, _INT, _P, _P,
                          _P],
    # dtype, n, w, d -> K5's path: slots per lane, 0 shared memory, -1 long
    # rows, -2 and -3 the channel entry's staged and in-place paths
    "repro_dtw_slots": [_INT, _INT, _INT, _INT],
}

#: Bytes of workspace a launch needs at its shape (0: none), one query per
#: entry that has a long-row path.
WORKSPACE_SIGNATURES = {
    # dtype, rows, n, w
    "repro_envelope_workspace": [_INT, _I64, _INT, _INT],
    # dtype, rows, n, w
    "repro_lb_improved_pass2_workspace": [_INT, _I64, _INT, _INT],
    # dtype, nq, nb, n, w, tile_b, grid_bq
    "repro_lb_fused_workspace": [_INT, _I64, _I64, _INT, _INT, _INT, _INT],
    # dtype, npairs, n, w, d
    "repro_dtw_workspace": [_INT, _I64, _INT, _INT, _INT],
}


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit
    PyTorch's extension builder finds; raise if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    try:
        from torch.utils.cpp_extension import CUDA_HOME
    except ImportError:
        CUDA_HOME = None
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the repro_torch "
        "CUDA kernels are built from source at first use"
    )


def build(force: bool = False) -> tuple[pathlib.Path, str]:
    """Compile the kernels if this source hash has no library yet.
    Returns (library path, compiler log)."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib_path.exists() and not force:
        return lib_path, log_path.read_text() if log_path.exists() else ""
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        t0 = time.perf_counter()
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append(
                (src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ))
            )
        log, objs, failed = [], [], []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        tmp_lib = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *objs, "-o", str(tmp_lib)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        log.append(f"== built in {time.perf_counter() - t0:.1f} s")
        out_dir.mkdir(parents=True, exist_ok=True)
        (tmp / "build.log").write_text("\n".join(log))
        os.replace(tmp / "build.log", log_path)
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builders agree
        return lib_path, "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), signatures set.
    Threads that launch kernels concurrently build and load it once."""
    with _LIBRARY_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in WORKSPACE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error (the launch never ran)."""
    if code != 0:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code} ({msg})")


def workspace(name: str, device, *shape_args):
    """The device workspace of a launch of kernel ``name`` at the shape
    ``shape_args`` (the arguments of ``repro_<name>_workspace`` after the
    dtype code, which comes first): a uint8 tensor of the bytes the
    library asks for, or None where the launch needs none."""
    import torch

    nbytes = int(getattr(library(), f"repro_{name}_workspace")(*shape_args))
    if nbytes <= 0:
        return None
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent optional argument)."""
    return None if t is None else t.data_ptr()


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
