"""repro_torch's ``QueryEngine`` over a session with a mesh (CPU).

Every rank of a multi-rank mesh would run its own engine, coalesce its
own arrivals into its own batches, and the sharded driver's collectives
would then pair different searches: a wrong answer and no error.  So the
engine refuses a session whose mesh spans more than one rank
(``NotImplementedError``, ROADMAP.md queue 1 item 11b), at construction
and, for a mesh attached later, at execution.  Two gloo ranks run as
subprocesses over a ``FileStore`` in the test's temporary directory (a
60 s group timeout, a process timeout); each builds the same session,
attaches ``make_host_mesh``, sees the engine refused, still searches
through the sharded driver, destroys its group and exits 0.  A one-rank
mesh stays served, every answer a direct ``db.search``'s bits.  No
outcome depends on timing.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from helpers import SRC  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.serve import QueryEngine  # noqa: E402

PROC_TIMEOUT = 240
ROWS, LENGTH, QUERIES = 400, 32, 4

#: one gloo rank: refuse the engine, then search through the mesh
RANK_CODE = r"""
import datetime, json, os, sys
import numpy as np
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
rows, length, queries = (int(a) for a in sys.argv[5:8])
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
try:
    from repro_torch.api import Database, SearchConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import QueryEngine

    rng = np.random.default_rng(0)
    x = rng.normal(size=(rows, length)).astype(np.float32).cumsum(1)
    qs = rng.normal(size=(queries, length)).astype(np.float32).cumsum(1)
    db = Database.build(x, SearchConfig(block=8), device="cpu")
    db.use_mesh(make_host_mesh(device="cpu"))
    try:
        QueryEngine(db, max_batch=4, max_wait_ms=300)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    res = db.search(qs)
    json.dump(dict(refused=refused, mesh=db.mesh.size, idx=res.indices[:, 0].tolist(),
                   dist=res.distances[:, 0].tolist()), open(out, "w"))
finally:
    dist.destroy_process_group()
"""


def walks(seed, rows, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


def test_engine_refuses_a_two_rank_mesh(tmp_path):
    world = 2
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    outs = [tmp_path / f"rank{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, str(r), str(world), str(tmp_path / "store"),
         str(outs[r]), str(ROWS), str(LENGTH), str(QUERIES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    failed = []
    for r, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=PROC_TIMEOUT)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"rank {r} exit {proc.returncode}\n{out}\n{err}")
    assert not failed, "\n".join(failed)
    ranks = [json.loads(o.read_text()) for o in outs]
    # the unsharded session's answers: what the sharded search still gives
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ROWS, LENGTH)).astype(np.float32).cumsum(1)
    qs = rng.normal(size=(QUERIES, LENGTH)).astype(np.float32).cumsum(1)
    want = Database.build(x, SearchConfig(block=8), device="cpu").search(qs)
    for got in ranks:
        assert got["mesh"] == world
        assert got["refused"] is not None and "item 11b" in got["refused"]
        assert got["idx"] == want.indices[:, 0].tolist()
        assert got["dist"] == want.distances[:, 0].tolist()


def test_one_rank_mesh_engine_answers_as_db_search():
    x, qs = walks(1, 60, 24), walks(2, 6, 24)
    db = Database.build(x, SearchConfig(block=8), device="cpu")
    mesh = make_host_mesh(device="cpu")
    try:
        db.use_mesh(mesh)
        assert mesh.size == 1 and db.plan(qs).driver == "sharded"
        with QueryEngine(db, max_batch=4, max_wait_ms=1.0) as engine:
            futures = [engine.submit(q) for q in qs]
            answers = [f.result(timeout=60) for f in futures]
        for q, a in zip(qs, answers):
            direct = db.search(q)
            assert np.array_equal(a.indices, direct.indices)
            assert a.distances.tobytes() == direct.distances.tobytes()
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_multi_rank_mesh_refused_at_construction_and_at_execution():
    """A stand-in mesh of two ranks (only its size is read): the constructor
    raises before any worker thread starts, and an engine whose session
    gets such a mesh after construction fails the request instead of
    searching."""
    x = walks(3, 40, 16)
    db = Database.build(x, SearchConfig(block=8), device="cpu")
    db.mesh = types.SimpleNamespace(size=2)
    with pytest.raises(NotImplementedError, match="item 11b"):
        QueryEngine(db)
    db.mesh = None
    engine = QueryEngine(db, max_batch=2, max_wait_ms=0.0, start=False)
    try:
        fut = engine.submit(x[0])
        db.mesh = types.SimpleNamespace(size=2)
        engine.start()
        with pytest.raises(NotImplementedError, match="item 11b"):
            fut.result(timeout=60)
    finally:
        engine.close()
    assert engine.stats().served == 0
