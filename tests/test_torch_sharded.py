"""repro_torch's sharded driver against repro.core.distributed (CPU).

Each mesh size S in {1, 2, 4} runs once: S torch ranks, each a
subprocess in a gloo group over a ``FileStore`` in the test's temporary
directory (one thread, a 60 s group timeout), beside one JAX subprocess
with S host devices (``helpers.run_in_subprocess``).  Both sides load
the same seeded numpy inputs and run every case of the mesh, the port
through ``repro_torch.core.distributed.sharded_nn_search`` (or
``Database.use_mesh``) on each rank, the reference through
``repro.core.distributed.sharded_nn_search`` (or ``repro.api.Database``).
Held: the same indices, distances within rtol 2e-4 (float32), every
per-query and aggregate counter equal, and every rank's result the
same.  Meshes (1,), (2,) and (2, 2), the last also sharded over
``("data",)`` alone; ``sync_every`` 1, 2 and 3 (3 leaves poison blocks,
swept and counted as in the reference); k 1 to 3; single queries and
batches; every pipeline at S = 1; p in {1, 2, inf}; d = 3 rows; a row
duplicated in two shards (the tie goes to the lower shard).

Float64 runs only on the port's side: with x64 on, the reference's
sharded driver raises the same ``lax.scan`` carry-type error as its scan
driver (ROADMAP.md fault D).  So float64 is held against the port's own
``nn_search_scan`` (the same bits; at S = 1 the same counters plus the
pad and poison lanes) and within 1e-12 of the float64 oracle.
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from helpers import SRC, run_in_subprocess  # noqa: E402
from repro.api import SearchConfig as JConfig  # noqa: E402
from repro.api.planner import plan_search as j_plan_search  # noqa: E402
from repro.core.distributed import pad_database as j_pad_database  # noqa: E402
from repro.core.dtw import dtw_reference  # noqa: E402
from repro.mv.dtw import dtw_reference_mv  # noqa: E402
from repro_torch.api import Database, SearchConfig  # noqa: E402
from repro_torch.api.planner import plan_search  # noqa: E402
from repro_torch.core.distributed import Mesh, pad_database, sharded_nn_search  # noqa: E402
from repro_torch.core.pipeline import PIPELINES  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.mv.layout import flatten_channels, unflatten_channels  # noqa: E402

torch.set_num_threads(1)

BLOCK, W, N = 8, 3, 32
#: mesh size -> (mesh shape, axis names, rows of the walks data)
MESHES = {1: ((1,), ("data",), 100), 2: ((2,), ("data",), 150), 4: ((2, 2), ("data", "model"), 250)}
#: the duplicated row's two places (shard 0 and shard 1 of the S = 2 mesh)
DUP = (7, 100)
PROC_TIMEOUT = 300


def case(data="walks", method="lb_improved", p=1, k=3, sync=3, single=False, axes=None,
         d=1, dtype="float32", facade=False):
    return dict(data=data, method=method, p=p, k=k, sync=sync, single=single, axes=axes,
                d=d, dtype=dtype, facade=facade)


#: every case of each mesh size; the p in {2, inf}, single-query and
#: sync_every 1 and 2 variants ride on pipelines of their own
VARIANTS = {"lb_webb": dict(p=2, k=1, sync=1, single=True), "kim_webb": dict(p="inf", k=2, sync=2)}
CASES = {
    1: {
        **{f"s1_{m}": case(method=m, **VARIANTS.get(m, {})) for m in PIPELINES},
        "s1_float64": case(p=2, dtype="float64"),
    },
    2: {
        "s2_lb_improved": case(),
        "s2_kim_improved": case(method="kim_improved", p=2, k=1, sync=1, single=True),
        "s2_tc_box": case(method="tc_box", p="inf", k=2),
        "s2_mv_d3": case(data="mv", p=2, k=2, d=3),
        "s2_dup_k1": case(data="dup", k=1, single=True),
        "s2_dup_k2": case(data="dup", k=2),
        "s2_facade": case(k=2, sync=2, facade=True),
        "s2_float64": case(p=2, dtype="float64"),
    },
    4: {
        "s4_sync3": case(k=2),
        "s4_sync1": case(k=2, sync=1),
        "s4_data_axis": case(axes=["data"]),
        "s4_pinf_single": case(p="inf", k=1, single=True),
    },
}

COMMON = r"""
import dataclasses, json, math, os
import numpy as np
BLOCK, W = %d, %d
spec = json.load(open(os.environ["SHARDED_SPEC"]))
inputs = np.load(os.environ["SHARDED_INPUTS"])


def dump(res):
    per_query = [dataclasses.asdict(s) for s in getattr(res, "per_query", ())]
    return dict(dist=np.asarray(res.distances, np.float64).tolist(),
                idx=np.asarray(res.indices).tolist(),
                stats=dataclasses.asdict(res.stats), per_query=per_query)


def arrays(c):
    x, qs = inputs[c["data"]], inputs[c["data"] + "_q"]
    if c["dtype"] == "float64":
        x, qs = x.astype(np.float64), qs.astype(np.float64)
    return x, (qs[0] if c["single"] else qs), (math.inf if c["p"] == "inf" else c["p"])
""" % (BLOCK, W)

#: the reference's side: every float32 case of one mesh in one process
JAX_CODE = COMMON + r"""
import jax
from jax.sharding import Mesh
from repro.api import Database, SearchConfig
from repro.core.distributed import pad_database, sharded_nn_search
from repro.launch.mesh import make_host_mesh

shape, names = spec["mesh"]
mesh = Mesh(np.array(jax.devices()).reshape(shape), tuple(names))
out = {}
for name, c in spec["cases"].items():
    if c["dtype"] != "float32":
        continue  # fault D: the x64 sharded driver raises
    x, q, p = arrays(c)
    if c["facade"]:
        cfg = SearchConfig(p=p, k=c["k"], block=BLOCK, method=c["method"])
        db = Database.build(x, cfg).use_mesh(make_host_mesh(), sync_every=c["sync"])
        res = db.search(q)
    else:
        axes = tuple(c["axes"]) if c["axes"] else None
        dbp, _ = pad_database(x, mesh, axes, block=BLOCK)
        res = sharded_nn_search(q, dbp, mesh, axes, w=W, p=p, k=c["k"], block=BLOCK,
                                sync_every=c["sync"], method=c["method"], d=c["d"])
    out[name] = dump(res)
json.dump(out, open(os.environ["SHARDED_OUT"], "w"))
"""

#: one torch rank: every case of one mesh
RANK_CODE = COMMON + r"""
import datetime, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group(
    "gloo", store=dist.FileStore(os.environ["SHARDED_STORE"], world), rank=rank,
    world_size=world, timeout=datetime.timedelta(seconds=60))
from repro_torch.api import Database, SearchConfig
from repro_torch.core.cascade import nn_search_scan
from repro_torch.core.distributed import Mesh, pad_database, sharded_nn_search
from repro_torch.launch.mesh import make_host_mesh

shape, names = spec["mesh"]
mesh = Mesh(shape, names, device="cpu")
out = {}
for name, c in spec["cases"].items():
    x, q, p = arrays(c)
    got = {}
    if c["facade"]:
        cfg = SearchConfig(p=p, k=c["k"], block=BLOCK, method=c["method"])
        db = Database.build(x, cfg, device="cpu")
        db.use_mesh(make_host_mesh(device="cpu"), sync_every=c["sync"])
        got["plan"] = db.plan(q).driver
        res = db.search(q)
        dbp, _ = pad_database(db.data, db.mesh, block=BLOCK)
        got["direct"] = dump(sharded_nn_search(
            db.prepare_queries(q), dbp, db.mesh, w=db.w, p=p, k=c["k"], block=BLOCK,
            sync_every=c["sync"], method=c["method"]))
    else:
        dbp, _ = pad_database(x, mesh, c["axes"], block=BLOCK)
        res = sharded_nn_search(q, dbp, mesh, c["axes"], w=W, p=p, k=c["k"], block=BLOCK,
                                sync_every=c["sync"], method=c["method"], d=c["d"])
        if c["dtype"] == "float64":
            got["scan"] = dump(nn_search_scan(q, x, W, p, c["k"], BLOCK, c["method"],
                                              c["d"], device="cpu"))
    got.update(dump(res))
    out[name] = got
dist.destroy_process_group()
json.dump(out, open(os.environ["SHARDED_OUT"], "w"))
"""


def walks(rng, rows, n):
    return rng.normal(size=(rows, n)).astype(np.float32).cumsum(axis=1)


def inputs_for(size: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(100 + size)
    arrs = {"walks": walks(rng, MESHES[size][2], N), "walks_q": walks(rng, 3, N)}
    if size == 2:
        dup = walks(rng, 150, N)
        dup[DUP[1]] = dup[DUP[0]]
        arrs["dup"] = dup
        arrs["dup_q"] = dup[DUP[0]][None] + 0.01 * rng.normal(size=(2, N)).astype(np.float32)
        arrs["mv"] = flatten_channels(walks(rng, 70 * 3, 20).reshape(70, 3, 20).transpose(0, 2, 1))
        arrs["mv_q"] = flatten_channels(walks(rng, 2 * 3, 20).reshape(2, 3, 20).transpose(0, 2, 1))
    return arrs


class Runs:
    """Both packages' results per mesh size, computed on first use."""

    def __init__(self, root):
        self.root = root
        self._done = {}

    def __call__(self, size: int):
        if size not in self._done:
            self._done[size] = self._run(size)
        return self._done[size]

    def _run(self, size: int):
        where = self.root / f"s{size}"
        where.mkdir()
        shape, names, _ = MESHES[size]
        spec_path, inputs_path = where / "spec.json", where / "inputs.npz"
        spec_path.write_text(json.dumps(dict(mesh=[shape, names], cases=CASES[size])))
        arrs = inputs_for(size)
        np.savez(inputs_path, **arrs)
        env = {"SHARDED_SPEC": str(spec_path), "SHARDED_INPUTS": str(inputs_path)}
        jax_out = where / "jax.json"
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            jax_run = pool.submit(
                run_in_subprocess, JAX_CODE, size,
                {**env, "SHARDED_OUT": str(jax_out), "JAX_PLATFORMS": "cpu"})
            procs = []
            for rank in range(size):
                penv = {**os.environ, **env, "SHARDED_STORE": str(where / "store"),
                        "SHARDED_OUT": str(where / f"rank{rank}.json"), "OMP_NUM_THREADS": "1",
                        "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", RANK_CODE, str(rank), str(size)], env=penv,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            failed = []
            for rank, proc in enumerate(procs):
                try:
                    out, err = proc.communicate(timeout=PROC_TIMEOUT)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"rank {rank} exit {proc.returncode}\n{out}\n{err}")
            jax_run.result()
        assert not failed, "\n".join(failed)
        ranks = [json.loads((where / f"rank{r}.json").read_text()) for r in range(size)]
        return dict(jax=json.loads(jax_out.read_text()), ranks=ranks, inputs=arrs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return Runs(tmp_path_factory.mktemp("sharded"))


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group for in-process checks, destroyed after."""
    mesh = make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def assert_same(got, want, rtol=2e-4):
    np.testing.assert_array_equal(np.asarray(got["idx"]), np.asarray(want["idx"]))
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=rtol)
    assert got["stats"] == want["stats"]
    assert got["per_query"] == want["per_query"]


REF_CASES = [(size, name) for size, cases in CASES.items() for name, c in cases.items()
             if c["dtype"] == "float32"]


@pytest.mark.parametrize("size,name", REF_CASES, ids=[n for _, n in REF_CASES])
def test_sharded_matches_reference(runs, size, name):
    r = runs(size)
    assert_same(r["ranks"][0][name], r["jax"][name])


@pytest.mark.parametrize("size", sorted(MESHES))
def test_every_rank_returns_the_same_result(runs, size):
    ranks = runs(size)["ranks"]
    assert len(ranks) == size
    for other in ranks[1:]:
        assert other == ranks[0]


@pytest.mark.parametrize("sync,extra", [(3, 96), (1, 0)])
def test_poison_lanes_are_swept_and_counted(runs, sync, extra):
    """250 rows on the (2, 2) mesh in blocks of 8: 256 padded rows, 8 blocks
    a shard.  sync_every=3 adds one poison block to each of the 4 shards,
    4 x 8 lanes x 3 queries = 96 lanes beyond n_candidates; sync_every=1
    adds none."""
    s = runs(4)["ranks"][0][f"s4_sync{sync}"]["stats"]
    assert s["n_candidates"] == 3 * 256 and s["blocks_total"] == 32
    assert sum(s["stage_pruned"]) + s["full_dtw"] == 3 * 256 + extra


def test_axis_subset_counts_each_shard_once(runs):
    """Sharded over "data" of the (2, 2) mesh: two shards of 128 rows, each
    held by two ranks; the counters close over one sweep of each shard."""
    s = runs(4)["ranks"][0]["s4_data_axis"]["stats"]
    nb = 128 // BLOCK
    lanes = 2 * (-(-nb // 3) * 3) * BLOCK
    assert s["blocks_total"] == 256 // BLOCK
    assert sum(s["stage_pruned"]) + s["full_dtw"] == 3 * lanes


def test_tie_goes_to_the_lower_shard(runs):
    r = runs(2)
    assert DUP[1] >= 80  # the copy is in shard 1 (80 rows a shard)
    assert r["ranks"][0]["s2_dup_k1"]["idx"] == [DUP[0]]
    assert r["ranks"][0]["s2_dup_k2"]["idx"] == [[DUP[0], DUP[1]]] * 2
    d = r["ranks"][0]["s2_dup_k2"]["dist"]
    assert all(row[0] == row[1] for row in d)


def test_multivariate_rows_match_the_oracle(runs):
    r = runs(2)
    x, qs = r["inputs"]["mv"], r["inputs"]["mv_q"]
    got = r["ranks"][0]["s2_mv_d3"]
    for qi, (idx, dist_) in enumerate(zip(got["idx"], got["dist"])):
        want = [dtw_reference_mv(unflatten_channels(qs[qi], 3), unflatten_channels(x[i], 3),
                                 W, 2) for i in idx]
        np.testing.assert_allclose(dist_, want, rtol=2e-4)
        brute = [dtw_reference_mv(unflatten_channels(qs[qi], 3), unflatten_channels(c, 3), W, 2)
                 for c in x]
        assert idx == np.argsort(brute, kind="stable")[: len(idx)].tolist()


@pytest.mark.parametrize("size", [1, 2])
def test_float64_against_the_scan_driver_and_oracle(runs, size):
    """Fault D: the reference's x64 sharded driver raises, so float64 is
    held against the port's scan driver and the float64 oracle."""
    r = runs(size)
    got = r["ranks"][0][f"s{size}_float64"]
    scan = got["scan"]
    assert got["idx"] == scan["idx"] and got["dist"] == scan["dist"]
    x, qs = r["inputs"]["walks"].astype(np.float64), r["inputs"]["walks_q"].astype(np.float64)
    for qi, (idx, dist_) in enumerate(zip(got["idx"], got["dist"])):
        want = [dtw_reference(qs[qi], x[i], W, 2) for i in idx]
        np.testing.assert_allclose(dist_, want, rtol=1e-12)
    if size == 1:
        # one shard prunes as the scan does: the same counters, plus the
        # pad and poison lanes, all pruned by the first LB stage
        n_real = x.shape[0]
        n_rows = -(-n_real // BLOCK) * BLOCK
        nb = n_rows // BLOCK
        extra = n_rows - n_real + (-(-nb // 3) * 3 - nb) * BLOCK
        for s, t in zip(got["per_query"], scan["per_query"]):
            assert s["n_candidates"] == n_rows and t["n_candidates"] == n_real
            assert s["stage_pruned"] == [t["stage_pruned"][0] + extra, *t["stage_pruned"][1:]]
            assert {key: s[key] for key in ("full_dtw", "blocks_lb2", "blocks_dtw",
                                            "dp_lane_work", "dp_lane_useful")} == {
                key: t[key] for key in ("full_dtw", "blocks_lb2", "blocks_dtw",
                                        "dp_lane_work", "dp_lane_useful")}


def test_use_mesh_matches_the_driver_and_the_reference_facade(runs):
    """Two ranks, each holding the session, over ``make_host_mesh()``'s
    (2, 1) mesh: the same bits as the driver on the padded rows, and the
    reference's facade over its (2, 1) host mesh."""
    r = runs(2)
    got = r["ranks"][0]["s2_facade"]
    assert got["plan"] == "sharded"
    direct = got["direct"]
    assert got["idx"] == direct["idx"] and got["dist"] == direct["dist"]
    assert got["stats"] == direct["stats"] and got["per_query"] == direct["per_query"]
    assert_same(got, r["jax"]["s2_facade"])


def test_planner_routes_a_mesh_as_the_reference():
    cfg = SearchConfig()
    plan = plan_search(cfg, 5000, 4, has_mesh=True)
    want = j_plan_search(JConfig(), 5000, 4, has_index=False, has_mesh=True)
    assert plan.driver == want.driver == "sharded" and plan.reasons == want.reasons
    assert plan_search(cfg, 5000, 4, has_mesh=True, has_index=True).driver == "indexed"
    assert plan_search(cfg, 5000, 4, has_mesh=True, driver="host").driver == "host"
    assert plan_search(cfg, 50, 4, has_mesh=True, driver="sharded").driver == "sharded"
    with pytest.raises(ValueError, match=r"driver='sharded' but no mesh is attached: call "
                                         r"Database\.use_mesh\(mesh\) first"):
        plan_search(cfg, 5000, 4, driver="sharded")


def test_error_contracts(one_rank_group):
    mesh = one_rank_group
    assert mesh.shape == {"data": 1, "model": 1} and mesh.backend == "gloo"
    x = walks(np.random.default_rng(5), 40, 16)
    db = Database.build(x, SearchConfig(block=BLOCK), device="cpu")
    with pytest.raises(ValueError, match="no mesh is attached"):
        db.search(x[:2], driver="sharded")
    with pytest.raises(ValueError, match="axis_names"):
        db.use_mesh(mesh, axis_names=("pod",))
    with pytest.raises(ValueError, match="axis_names"):
        pad_database(x, mesh, ("data", "data"))
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_nn_search(x[0], x[:36], mesh, w=2, block=BLOCK)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        Mesh((2, 2), ("data", "model"), device="cpu")
    # a mesh is not saved: the bundle loads as a session without one
    db.use_mesh(mesh, sync_every=2)
    assert db.plan(x[:2]).driver == "sharded" and "mesh=attached" in repr(db)
    res = db.search(x[:2])
    assert res.stats.n_candidates == 2 * 40 and res.indices[:, 0].tolist() == [0, 1]
    # the same group is reused, not created again
    assert make_host_mesh(device="cpu").size == 1 and dist.get_world_size() == 1


def test_cuda_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh((1,), ("data",))
    assert not dist.is_initialized()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pad_database_matches_the_reference(one_rank_group, dtype):
    class JMesh:  # what the reference reads of a mesh
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 1}

    x = walks(np.random.default_rng(6), 37, 8).astype(dtype)
    got, n = pad_database(x, one_rank_group, block=5)
    want, n_j = j_pad_database(x, JMesh(), block=5)
    assert n == n_j == 37 and got.shape == (40, 8) and got.dtype == want.dtype
    assert np.array_equal(got, want)
