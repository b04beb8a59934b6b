"""Paper Section 7 on the PyTorch port: which DTW_p classifies best?
(the twin of ``examples/classify_timeseries.py``).

1-NN classification over Cylinder-Bell-Funnel with p in {1, 2, 4, inf}
(reduced replication of Figure 2) — DTW_1 should win or tie.  The
session API serves the norms the kernels are built for, {1, 2, inf}: one
``Database`` per norm is built over the training set on the device and
``db.classify`` predicts every test series in one query-major sweep.
The kernels take no other norm, so the DTW_4 row goes through
``classification_accuracy`` on the CPU, where every stage runs its plain
PyTorch version.  Runs on the GPU; ``--device cpu`` runs every row on
the plain versions.

    PYTHONPATH=src python examples/classify_timeseries_torch.py
    PYTHONPATH=src python examples/classify_timeseries_torch.py --device cpu
"""

import argparse
import math

import numpy as np

from repro_torch.api import Database, SearchConfig
from repro_torch.core.classify import classification_accuracy
from repro_torch.data.synthetic import cylinder_bell_funnel


def main(device=None) -> dict:
    """Print and return each norm's accuracy, keyed 1, 2, 4 and "inf"."""
    rng = np.random.default_rng(0)
    train_x, train_y = cylinder_bell_funnel(rng, 6)
    test_x, test_y = cylinder_bell_funnel(rng, 10)
    w = train_x.shape[1] // 10

    print(f"train {train_x.shape}, test {test_x.shape}, w={w}")
    accs = {}
    for p in (1, 2, 4, math.inf):
        name = "inf" if p == math.inf else p
        if p == 4:  # no kernel serves this norm: the CPU's plain versions do
            acc = classification_accuracy(
                test_x, test_y, train_x, train_y, w=w, p=p, device="cpu"
            )
            where = " (on the CPU's plain versions: the kernels serve p in {1, 2, inf})"
        else:
            db = Database.build(train_x, SearchConfig(w=w, p=p), device=device)
            pred = db.classify(train_y, test_x)
            acc = float(np.mean(pred == test_y))
            where = ""
        accs[name] = acc
        print(f"DTW_{name}: accuracy {acc:.3f}{where}")
    best = max(accs, key=accs.get)
    print(f"\nbest: DTW_{best} (paper: DTW_1 best overall, DTW_2 close second)")
    return accs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; 'cpu' runs the plain versions)")
    main(ap.parse_args().device)
