"""Reference selection for the triangle index (port of
``repro.index.references``).

Stage-0 pruning power depends on how well the references cover the
database under DTW: LB_tri is tight for a candidate c when some
reference sits close to c or close to q.  Two strategies:

* ``maxmin`` — farthest-first traversal (the 2-approximation to the
  k-center problem): start from the series nearest the database mean,
  then repeatedly pick the series farthest from the chosen set.  Each
  round is one banded-DTW sweep of one row against all rows.
* ``random`` — a uniform sample, the baseline.

Both return the selected indices and the (R, N) rooted distance matrix
the selection already paid for, so ``build_index`` never recomputes a
reference row.  A sweep is ``kernels/dtw/ops.py::dtw_op``: the DP kernel
(K5, its channel entry for multivariate rows) on CUDA tensors, its plain
version on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dtw import PNorm
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.dtw.ops import dtw_op


def _ref_row(db: torch.Tensor, ridx: int, w: int, p: PNorm, d: int = 1) -> np.ndarray:
    """Rooted DTW from db[ridx] to every series: one sweep."""
    return dtw_op(db[ridx], db, w, p, d=d).cpu().numpy()


def select_references(
    db, n_refs: int, w: int, p: PNorm = 1, strategy: str = "maxmin",
    rng: np.random.Generator | None = None, d: int = 1, device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pick ``n_refs`` database series as references, on ``db``'s device
    (or ``device``); rows are channel-major flattened (d*n,) when ``d >
    1``, and the distances dependent mv DTW.  Returns (ref_idx (R,),
    d_ref_db (R, N)) with rooted distances."""
    d = int(d)
    dev = resolve_device(device, like=db)
    db = torch.as_tensor(db, device=dev).contiguous()
    n_db = db.shape[0]
    if not 0 < n_refs <= n_db:
        raise ValueError(f"n_refs must be in [1, {n_db}], got {n_refs}")
    rng = rng if rng is not None else np.random.default_rng(0)

    if strategy == "random":
        idx = np.sort(rng.choice(n_db, size=n_refs, replace=False))
        rows = np.stack([_ref_row(db, int(i), w, p, d) for i in idx])
        return idx.astype(np.int64), rows

    if strategy != "maxmin":
        raise ValueError(f"unknown strategy {strategy!r}")

    # farthest-first traversal, seeded at the most central series (l2 to
    # the pointwise mean, in the rows' dtype as the reference computes it)
    mean = db.mean(dim=0)
    seed = int(((db - mean[None, :]) ** 2).sum(dim=1).argmin())
    chosen = [seed]
    rows = [_ref_row(db, seed, w, p, d)]
    min_d = rows[0].copy()
    for _ in range(1, n_refs):
        min_d[np.asarray(chosen)] = -1.0  # never re-pick a reference
        nxt = int(np.argmax(min_d))
        chosen.append(nxt)
        row = _ref_row(db, nxt, w, p, d)
        rows.append(row)
        min_d = np.minimum(min_d, row)
    # FFT order: any prefix of the traversal is itself a good cover, so
    # build_index reuses the first C picks as cluster representatives
    return np.asarray(chosen, np.int64), np.stack(rows)
