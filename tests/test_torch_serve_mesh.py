"""repro_torch's ``QueryEngine`` over a session with a mesh (CPU).

The reference serves a sharded session from one controller.  The port
runs one process a rank, so every rank builds the same session, attaches
the mesh and makes the engine: rank 0 admits, coalesces and caches, and
sends each batch its planner routes to the sharded driver to every other
rank, whose follower thread runs the same ``db.search``; the sharded
driver's collectives then pair the same searches.

Gloo ranks run as subprocesses over a ``FileStore`` in the test's
temporary directory (a 60 s group timeout, a process timeout): two ranks
over ``("data",)`` and four as ``make_host_mesh(model_axis=2)``'s (2, 2).
Every rank makes the engine with ``start=False``; rank 0 stages the
same requests from two tenants (the queries, an in-flight duplicate, a
``k=2`` request and a ``driver="scan"`` request), starts the engine,
then sends a repeated query (a cache hit).  One JAX subprocess with 4
host devices runs ``repro.serve.QueryEngine`` over ``repro``'s
``use_mesh`` sessions with the same staging.  Held: the same indices,
distances within rtol 2e-4, per-answer ``pruned_by``/``full_dtw`` and the
``EngineStats`` counts equal; every follower ran exactly rank 0's
sharded batches (not the cache hit, not the scan batch); every answer
bit-equal to rank 0's direct ``db.search`` of its batch, replayed on
every rank after ``close``; and the group not wedged.  Two ranks also
serve an anytime request on rank 0 alone, refuse ``submit`` on the
follower, refuse mismatched sessions or ``max_batch`` on both ranks, and
fail a request whose session got its mesh after the engine was made.
A one-rank mesh stays served, every answer a direct ``db.search``'s bits.
No outcome depends on timing.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from helpers import SRC, run_in_subprocess  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.serve import QueryEngine  # noqa: E402

torch.set_num_threads(1)

PROC_TIMEOUT = 240
RTOL = 2e-4
#: gloo ranks of each run: a (2,) ("data",) mesh, make_host_mesh(model_axis=2)'s (2, 2)
WORLDS = (2, 4)
LATE_MESH = "make the engine after use_mesh"

#: both packages' data, staging and answer records
COMMON = r"""
import numpy as np

ROWS, LENGTH, QUERIES, BLOCK = 400, 32, 6, 8
#: the anytime session (tests/test_torch_serve_anytime.py's shapes)
ANY_ROWS, ANY_N, ANY_M, ANY_OPTS = 24, 80, 40, dict(lengths=(40, 80), hop=4, leaf_size=8)
ANY_CFG = dict(w=6, p=1, k=3)
ENGINE = dict(max_batch=4, max_wait_ms=1.0, start=False)
STATS = ("submitted", "served", "cache_hits", "coalesced", "batches", "batch_lanes")


def walks(rng, rows, n):
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(1)


rng = np.random.default_rng(0)
X, QS = walks(rng, ROWS, LENGTH), walks(rng, QUERIES, LENGTH)
rng = np.random.default_rng(3)
ANY_X, ANY_QS = walks(rng, ANY_ROWS, ANY_N), walks(rng, 2, ANY_N)
#: (tenant, query, submit overrides), staged before the engine starts:
#: batch 1 q0 q1 q2 q3 (the second q0 coalesces), batch 2 q4 q5, then the
#: k=2 batch and the scan batch
STAGED = [("a", 0, {}), ("b", 1, {}), ("a", 2, {}), ("b", 0, {}), ("a", 3, {}),
          ("b", 4, {}), ("a", 5, {}), ("a", 1, {"k": 2}), ("b", 2, {"driver": "scan"})]
ANY_STAGED = [("a", 0, {"mode": "anytime"}), ("b", 1, {})]
REPEAT = ("b", 3)  # after the staged answers: a cache hit


def dump(a):
    return dict(idx=np.asarray(a.indices).tolist(),
                dist=np.asarray(a.distances, np.float64).tolist(),
                pruned_by=dict(a.stats.pruned_by), full_dtw=int(a.stats.full_dtw),
                tenant=a.tenant, cache_hit=bool(a.cache_hit), coalesced=bool(a.coalesced),
                lanes=int(a.batch_lanes))


def serve(engine, qs, staged, repeat=None):
    futures = [engine.submit(qs[i], tenant=t, **kw) for t, i, kw in staged]
    engine.start()
    answers = [f.result(timeout=120) for f in futures]
    if repeat is not None:
        answers.append(engine.submit(qs[repeat[1]], tenant=repeat[0]).result(timeout=120))
    s = engine.stats()
    return answers, {f: getattr(s, f) for f in STATS}
"""

#: the reference: repro's engine over repro's sharded sessions, 4 host devices
JAX_CODE = COMMON + r"""
import json, os
import jax
from jax.sharding import Mesh
from repro.api import Database, SearchConfig
from repro.launch.mesh import make_host_mesh
from repro.serve import QueryEngine

out = {}
meshes = {2: Mesh(np.array(jax.devices()[:2]), ("data",)), 4: make_host_mesh(model_axis=2)}
for size, mesh in meshes.items():
    db = Database.build(X, SearchConfig(block=BLOCK)).use_mesh(mesh)
    engine = QueryEngine(db, **ENGINE)
    answers, stats = serve(engine, QS, STAGED, REPEAT)
    engine.close()
    out[str(size)] = dict(answers=[dump(a) for a in answers], stats=stats)
db = Database.build(ANY_X, SearchConfig(**ANY_CFG), anytime=ANY_OPTS).use_mesh(meshes[2])
engine = QueryEngine(db, **ENGINE)
answers, stats = serve(engine, ANY_QS, ANY_STAGED)
engine.close()
out["anytime"] = dict(answers=[dump(a) for a in answers], stats=stats)
json.dump(out, open(os.environ["SERVE_MESH_OUT"], "w"))
"""

#: one gloo rank of the port: every case of its mesh size
RANK_CODE = COMMON + r"""
import datetime, hashlib, json, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from repro_torch.api import Database, SearchConfig
from repro_torch.core.distributed import Mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import QueryEngine


def make_mesh():
    if world == 2:
        return Mesh((2,), ("data",), device="cpu")
    return make_host_mesh(model_axis=2, device="cpu")


def recorded(db):
    # every db.search call of the session: (block, kwargs, result)
    calls, search = [], db.search

    def record(block, **kw):
        res = search(block, **kw)
        calls.append((np.array(block), kw, res))
        return res

    db.search = record
    return calls, search


def call_key(block, kw):
    return [hashlib.sha256(block.tobytes()).hexdigest(), sorted(kw.items())]


def same_bits(a, b):
    return a.tobytes() == b.tobytes() and a.dtype == b.dtype


def run_case(db, qs, staged, repeat):
    db.use_mesh(make_mesh())
    calls, search = recorded(db)
    engine = QueryEngine(db, **ENGINE)
    got = {}
    if rank == 0:
        answers, got["stats"] = serve(engine, qs, staged, repeat)
        got["answers"] = [dump(a) for a in answers]
    else:
        try:
            engine.submit(qs[0])
        except RuntimeError as e:
            got["submit_refused"] = str(e)
        engine.start()
    engine.close(timeout=120)
    got["mirrored_batches"] = engine.mirrored_batches
    sharded = [db.plan(b, driver=kw.get("driver"), method=kw.get("method"), k=kw.get("k"),
                       mode=kw.get("mode", "exact"), budget=kw.get("budget")).driver == "sharded"
               for b, kw, _ in calls]
    got["sharded_calls"] = [call_key(b, kw) for (b, kw, _), s in zip(calls, sharded) if s]
    got["local_calls"] = [call_key(b, kw) for (b, kw, _), s in zip(calls, sharded) if not s]
    # every call again, straight to the session: the sharded ones pair with
    # the followers' replays, in the same order
    direct = [search(b, **kw) for b, kw, _ in calls]
    if rank == 0:
        same = []
        answers = answers[: len(staged)]  # the cache hit ran no batch
        for (t, i, kw), a in zip(staged, answers):
            mode = kw.get("mode", "exact")
            hits = [(b, r) for (b, ckw, _), r in zip(calls, direct)
                    if ckw.get("k") == (kw.get("k") or a.indices.size)
                    and ckw.get("driver") == kw.get("driver")
                    and ckw.get("mode", "exact") == mode and (b == qs[i]).all(1).any()]
            b, r = hits[0]
            lane = int(np.flatnonzero((b == qs[i]).all(1))[0])
            d = r.distances[lane] if mode == "exact" else r[lane].distances
            ix = r.indices[lane] if mode == "exact" else r[lane].indices
            same.append(len(hits) == 1 and same_bits(a.distances, d)
                        and np.array_equal(a.indices, ix))
        got["same_as_direct"] = same
    res = search(qs)  # the group is not wedged
    got["direct_idx"] = np.asarray(res.indices).tolist()
    return got


out = {}
try:
    db = Database.build(X, SearchConfig(block=BLOCK), device="cpu")
    out["main"] = run_case(db, QS, STAGED, REPEAT)
    if world == 2:
        any_db = Database.build(ANY_X, SearchConfig(**ANY_CFG), anytime=ANY_OPTS, device="cpu")
        out["anytime"] = run_case(any_db, ANY_QS, ANY_STAGED, None)
        # different sessions, then a different max_batch: refused on both ranks
        refused = []
        x = X[:64].copy()
        x[0, 0] += rank
        for rows, max_batch in ((x, 4), (X[:64], 4 + rank)):
            small = Database.build(rows, SearchConfig(block=BLOCK), device="cpu")
            small.use_mesh(make_mesh())
            try:
                QueryEngine(small, max_batch=max_batch)
                refused.append(None)
            except ValueError as e:
                refused.append(str(e))
        out["refused"] = refused
        if rank == 0:  # the mesh attached after the engine was made
            late = Database.build(X[:64], SearchConfig(block=BLOCK), device="cpu")
            engine = QueryEngine(late, **ENGINE)
            fut = engine.submit(QS[0])
            late.use_mesh(make_mesh())
            engine.start()
            out["late"] = repr(fut.exception(timeout=60))
            engine.close()
            out["late_served"] = engine.stats().served
finally:
    dist.destroy_process_group()
json.dump(out, open(out_path, "w"))
"""


def run_ranks(world, where):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    outs = [where / f"rank{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, str(r), str(world), str(where / "store"),
         str(outs[r])], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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
    return [json.loads(o.read_text()) for o in outs]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' results: {"jax": ..., 2: [rank dicts], 4: [...]}."""
    root = tmp_path_factory.mktemp("serve_mesh")
    jax_out = root / "jax.json"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_in_subprocess, JAX_CODE, 4,
                              {"SERVE_MESH_OUT": str(jax_out), "JAX_PLATFORMS": "cpu"})
        got = {}
        for world in WORLDS:
            (root / f"s{world}").mkdir()
            got[world] = run_ranks(world, root / f"s{world}")
        jax_run.result()
    got["jax"] = json.loads(jax_out.read_text())
    return got


def same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["idx"] == w["idx"]
        np.testing.assert_allclose(g["dist"], w["dist"], rtol=RTOL)
        for f in ("pruned_by", "full_dtw", "tenant", "cache_hit", "coalesced", "lanes"):
            assert g[f] == w[f], f


def check_served(served, world):
    """Rank 0's engine over ``world`` gloo ranks gives the reference
    engine's answers, counts and stats, each answer its batch's direct
    search bits."""
    ranks = served[world]
    main = ranks[0]["main"]
    same_answers(main["answers"], served["jax"][str(world)]["answers"])
    assert main["stats"] == served["jax"][str(world)]["stats"]
    assert main["stats"]["cache_hits"] == 1 and main["stats"]["coalesced"] == 1
    assert main["answers"][-1]["cache_hit"]
    assert all(main["same_as_direct"]) and len(main["same_as_direct"]) == 9


def test_engine_refuses_a_two_rank_mesh(served):
    """The former refusal of two ranks, now served."""
    check_served(served, 2)


def test_engine_serves_a_four_rank_mesh(served):
    """Four ranks as ``make_host_mesh(model_axis=2)``'s (2, 2) mesh."""
    check_served(served, 4)


@pytest.mark.parametrize("world", WORLDS)
def test_followers_mirror_rank0_sharded_batches(served, world):
    """Three sharded batches (two default, one k=2); neither the cache hit
    nor the scan batch is sent.  Every follower ran rank 0's sharded calls,
    block for block, and refused ``submit``."""
    ranks = served[world]
    lead = ranks[0]["main"]
    assert lead["mirrored_batches"] == 3
    assert len(lead["sharded_calls"]) == 3 and len(lead["local_calls"]) == 1
    assert dict(lead["local_calls"][0][1])["driver"] == "scan"
    for r in ranks[1:]:
        f = r["main"]
        assert f["mirrored_batches"] == 3
        assert f["sharded_calls"] == lead["sharded_calls"] and f["local_calls"] == []
        assert "admits requests on the mesh's rank 0" in f["submit_refused"]
    # after close, every rank's direct search: the unsharded session's answer
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 32)).astype(np.float32).cumsum(1)
    qs = rng.normal(size=(6, 32)).astype(np.float32).cumsum(1)
    want = Database.build(x, SearchConfig(block=8), device="cpu").search(qs)
    for r in ranks:
        assert r["main"]["direct_idx"] == want.indices.tolist()


def test_anytime_request_is_served_on_rank0_alone(served):
    """On a session with an anytime tier the anytime batch runs on rank 0
    without a message; the exact batch beside it is mirrored."""
    lead, follower = (r["anytime"] for r in served[2])
    want = served["jax"]["anytime"]
    same_answers(lead["answers"][1:], want["answers"][1:])
    any_got, any_want = lead["answers"][0], want["answers"][0]
    assert any_got["idx"] == any_want["idx"]  # unlimited: the exact answer
    np.testing.assert_allclose(any_got["dist"], any_want["dist"], rtol=RTOL)
    assert lead["stats"] == want["stats"]
    assert all(lead["same_as_direct"])
    assert lead["mirrored_batches"] == follower["mirrored_batches"] == 1
    assert follower["sharded_calls"] == lead["sharded_calls"]
    assert all(dict(kw).get("mode") == "anytime" for _, kw in lead["local_calls"])


def test_mismatched_ranks_are_refused_on_every_rank(served):
    for r in served[2]:
        fingerprint, max_batch = r["refused"]
        assert fingerprint is not None and "sessions or max_batch differ" in fingerprint
        assert max_batch is not None and "max_batch 5" in max_batch


def test_mesh_attached_after_the_engine_fails_the_batch(served):
    lead = served[2][0]
    assert "RuntimeError" in lead["late"] and LATE_MESH in lead["late"]
    assert lead["late_served"] == 0


def walks(seed, rows, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


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
        assert engine.mirrored_batches == 0
        for q, a in zip(qs, answers):
            direct = db.search(q)
            assert np.array_equal(a.indices, direct.indices)
            assert a.distances.tobytes() == direct.distances.tobytes()
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_multi_rank_mesh_refused_at_construction_and_at_execution():
    """A stand-in mesh of two ranks (only its size is read) attached after
    the engine was made, to a session without a mesh and to one whose mesh
    was one rank: the request fails with the ``RuntimeError`` that names
    the fix instead of searching.  Construction over a real multi-rank
    mesh (the exchange, its refusals) runs in the gloo subprocesses."""
    x = walks(3, 40, 16)
    db = Database.build(x, SearchConfig(block=8), device="cpu")
    engine = QueryEngine(db, max_batch=2, max_wait_ms=0.0, start=False)
    try:
        fut = engine.submit(x[0])
        db.mesh = types.SimpleNamespace(size=2)
        engine.start()
        with pytest.raises(RuntimeError, match=LATE_MESH):
            fut.result(timeout=60)
    finally:
        engine.close()
    assert engine.stats().served == 0
    db.mesh = None
    mesh = make_host_mesh(device="cpu")
    try:
        db.use_mesh(mesh)
        engine = QueryEngine(db, max_batch=2, max_wait_ms=0.0, start=False)
        fut = engine.submit(x[1])
        db.mesh = types.SimpleNamespace(size=2)
        engine.start()
        with pytest.raises(RuntimeError, match=LATE_MESH):
            fut.result(timeout=60)
        engine.close()
        assert engine.stats().served == 0
    finally:
        dist.destroy_process_group()
