"""1-NN time-series classification under DTW_p — paper Section 7
(port of ``repro.core.classify``)."""

from __future__ import annotations

import numpy as np

from repro_torch.core.cascade import nn_search_scan
from repro_torch.core.dtw import PNorm


def nn_classify(
    query: np.ndarray,
    train_x: np.ndarray,
    train_y: np.ndarray,
    w: int,
    p: PNorm = 1,
    method: str = "lb_improved",
    device=None,
) -> int:
    res = nn_search_scan(query, train_x, w=w, p=p, k=1, method=method, device=device)
    return int(train_y[res.index])


def classification_accuracy(
    test_x: np.ndarray,
    test_y: np.ndarray,
    train_x: np.ndarray,
    train_y: np.ndarray,
    w: int,
    p: PNorm = 1,
    method: str = "lb_improved",
    device=None,
) -> float:
    hits = 0
    for q, label in zip(test_x, test_y):
        pred = nn_classify(q, train_x, train_y, w, p, method, device)
        hits += int(pred == int(label))
    return hits / max(len(test_y), 1)
