"""repro_torch's search CLI and quickstart against repro's (CPU).

``repro_torch.launch.search.main`` with ``--device cpu`` and
``repro.launch.search.main`` run on the same small flags; their
``query i:`` lines are parsed and compared.  With ``--index`` both serve
through the stage-0 triangle index: the same ``nn``, ``stage0=``,
``clusters=``, ``pruned_*`` and ``dtw=`` counts, and ``dist`` within rtol
2e-4 (plus half of the line's 3-decimal rounding).  Without ``--index``
both serve through a one-device host mesh (the sharded driver) and print
the same mesh line, ``nn``, ``dist``, ``pruned_*`` and ``dtw=``; the
port's one-rank gloo group is destroyed after the test.  The quickstart
twin runs small, its exactness asserts included; the search service twin
runs at its full size over 8 gloo ranks beside the reference example
over 8 host devices, both as subprocesses.
"""

import importlib.util
import math
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from helpers import SRC, run_in_subprocess  # noqa: E402
from repro.launch import search as j_cli  # noqa: E402
from repro_torch.api.planner import SMALL_DB_ROWS  # noqa: E402
from repro_torch.launch import search as t_cli  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--db-size", "200", "--length", "64", "--queries", "3"]
INDEXED = ["--index", "--p", "inf", "--n-refs", "6"]
QUERY_LINE = re.compile(r"^query (\d+): nn=(\d+) dist=([0-9.]+) (.*)$")
ERR = re.compile(r"err<=([0-9.]+|inf) ")


def parse(out: str) -> list[dict]:
    """The ``query i:`` lines: nn, dist and every ``key=value`` count."""
    rows = []
    for line in out.splitlines():
        m = QUERY_LINE.match(line)
        if m:
            counts = dict(re.findall(r"(\w+)=(\d+(?:/\d+)?)", m.group(4)))
            err = ERR.search(m.group(4))
            rows.append(dict(i=int(m.group(1)), nn=int(m.group(2)),
                             dist=float(m.group(3)), **counts,
                             **({"err": float(err.group(1))} if err else {})))
    return rows


def run_port(capsys, args):
    t_cli.main(["--device", "cpu", *args])
    return capsys.readouterr().out


def run_reference(capsys, monkeypatch, args):
    monkeypatch.setattr(sys, "argv", ["repro.launch.search", *args])
    j_cli.main()
    return capsys.readouterr().out


def close(a: float, b: float) -> bool:
    # rtol 2e-4, plus half a unit of the line's third decimal
    return abs(a - b) <= 2e-4 * abs(b) + 5e-4


@pytest.mark.parametrize("indexed", [True, False], ids=["index", "no_index"])
def test_cli_lines_match_reference(capsys, monkeypatch, indexed):
    args = SMALL + (INDEXED if indexed else [])
    try:
        port_out = run_port(capsys, args)
    finally:
        if dist.is_initialized():  # the mesh route's one-rank group
            dist.destroy_process_group()
    ref_out = run_reference(capsys, monkeypatch, args)
    port, ref = parse(port_out), parse(ref_out)
    assert len(port) == len(ref) == 3
    keys = ("pruned_lb_keogh", "pruned_lb_improved", "dtw")
    if indexed:
        keys += ("stage0", "clusters")
    for a, b in zip(port, ref):
        assert a["nn"] == b["nn"] and close(a["dist"], b["dist"]), (a, b)
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    if indexed:
        assert "driver: indexed (repro_torch.core.cascade.nn_search_indexed)" in port_out
        assert not any(ln.startswith("mesh=") for ln in port_out.splitlines())
    else:
        mesh_line = "mesh={'data': 1, 'model': 1}"
        assert mesh_line in port_out.splitlines() and mesh_line in ref_out.splitlines()
        assert "driver: sharded (repro_torch.core.distributed.sharded_nn_search)" in port_out
    assert "served 3 queries" in port_out


def test_cli_bundle_and_index_paths(capsys, monkeypatch, tmp_path):
    """--index-path builds then loads the index with the same answers;
    --db-path builds and saves the session bundle, and a second run serves
    it (its queries then start the seed's stream, as the reference's do),
    answering as the reference's CLI does on the same bundle."""
    idx, bundle = str(tmp_path / "idx"), str(tmp_path / "session")
    first = parse(run_port(capsys, SMALL + INDEXED + ["--index-path", idx]))
    out = run_port(capsys, SMALL + INDEXED + ["--index-path", idx])
    assert "loaded index from" in out and parse(out) == first
    built = run_port(capsys, SMALL + INDEXED + ["--db-path", bundle])
    assert "saved session bundle to" in built and parse(built) == first
    loaded = run_port(capsys, SMALL + ["--db-path", bundle])
    assert "loaded session bundle from" in loaded and "--index: bundle=has" in loaded
    ref = run_reference(capsys, monkeypatch, SMALL + ["--db-path", bundle])
    port, want = parse(loaded), parse(ref)
    assert [r["nn"] for r in port] == [r["nn"] for r in want]
    assert [{k: v for k, v in r.items() if k != "dist"} for r in port] == [
        {k: v for k, v in r.items() if k != "dist"} for r in want]
    assert all(close(a["dist"], b["dist"]) for a, b in zip(port, want))


def outcome(fn):
    """What a CLI run gave: its parsed query lines, or the error it raised
    (type and text)."""
    try:
        return "lines", parse(fn())
    except Exception as e:  # noqa: BLE001 - the outcome is the error
        return type(e), str(e)
    finally:
        if dist.is_initialized():  # the mesh route's one-rank group
            dist.destroy_process_group()


def same_lines(port, ref):
    """The port's query lines against the reference's: every count equal,
    ``dist`` and ``err`` within rtol 2e-4 (plus the line's rounding)."""
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert {k: v for k, v in a.items() if k not in ("dist", "err")} == {
            k: v for k, v in b.items() if k not in ("dist", "err")}
        assert close(a["dist"], b["dist"]), (a, b)
        if "err" in b:
            assert close(a["err"], b["err"]), (a, b)


@pytest.mark.parametrize("flags", [["--anytime", "32"], ["--mode", "anytime"],
                                   ["--query-length", "32"]], ids=lambda f: f[0])
def test_cli_anytime_flags_raise(capsys, monkeypatch, flags):
    """Each anytime flag alone ends as the reference CLI's run does:
    ``--anytime 32`` builds the tier and serves the exact lines,
    ``--mode anytime`` without a tier and ``--query-length 32`` without
    one raise the reference's ``ValueError``."""
    port = outcome(lambda: run_port(capsys, SMALL + flags))
    ref = outcome(lambda: run_reference(capsys, monkeypatch, SMALL + flags))
    assert port[0] == ref[0]
    if port[0] == "lines":
        same_lines(port[1], ref[1])
    else:
        assert port == ref and port[0] is ValueError


ANYTIME = ["--anytime", "32,64", "--mode", "anytime"]


@pytest.mark.parametrize("flags", [[], ["--budget", "64"], ["--query-length", "32"],
                                   ["--query-length", "32", "--budget", "64"]],
                         ids=["whole", "budget", "subsequence", "subsequence_budget"])
def test_cli_anytime_lines_match_reference(capsys, monkeypatch, flags):
    """``--anytime 32,64 --mode anytime``: the same ``nn``, ``refined``,
    ``clusters``, ``pruned_*`` and ``dtw`` counts, and ``dist`` and the
    ``err<=`` bound within rtol 2e-4; no mesh on the anytime route."""
    port_out = run_port(capsys, SMALL + ANYTIME + flags)
    assert not dist.is_initialized()
    assert not any(ln.startswith("mesh=") for ln in port_out.splitlines())
    ref_out = run_reference(capsys, monkeypatch, SMALL + ANYTIME + flags)
    port, ref = parse(port_out), parse(ref_out)
    assert len(port) == 3 and all("refined" in r and "clusters" in r for r in port)
    same_lines(port, ref)
    budget = "budget 64 refined windows/query" if "--budget" in flags else "budget unlimited"
    assert budget in port_out and "mode: anytime" in port_out


def test_cli_anytime_bundle_round_trip_and_warning(capsys, monkeypatch, tmp_path):
    """A bundle saved with the tier serves ``--mode anytime`` after a load
    as the reference CLI does on the same bundle; a bundle without one
    prints the reference's ``--anytime`` warning and serves exactly."""
    tier, plain = str(tmp_path / "tier"), str(tmp_path / "plain")
    sub = ANYTIME + ["--query-length", "32", "--budget", "64"]
    built = run_port(capsys, SMALL + sub + ["--db-path", tier])
    loaded = run_port(capsys, SMALL + sub + ["--db-path", tier])
    assert "saved session bundle to" in built and "loaded session bundle from" in loaded
    ref = run_reference(capsys, monkeypatch, SMALL + sub + ["--db-path", tier])
    same_lines(parse(loaded), parse(ref))
    assert [r["nn"] for r in parse(loaded)] == [r["nn"] for r in parse(ref)]
    run_port(capsys, SMALL + INDEXED + ["--db-path", plain])
    flags = SMALL + INDEXED + ["--anytime", "32", "--db-path", plain]
    port_out = run_port(capsys, flags)
    ref_out = run_reference(capsys, monkeypatch, flags)
    warning = [ln.strip() for ln in port_out.splitlines() if ln.strip().startswith("--anytime:")]
    assert warning == [ln.strip() for ln in ref_out.splitlines()
                       if ln.strip().startswith("--anytime:")]
    assert len(warning) == 1 and "no anytime tier" in warning[0]
    same_lines(parse(port_out), parse(ref_out))


def test_classify_twin_runs_on_cpu(capsys):
    """examples/classify_timeseries_torch.py: p in {1, 2, inf} through the
    port's ``db.classify`` and DTW_4 through ``classification_accuracy`` on
    the CPU, each equal to repro's on the same data."""
    import jax.numpy as jnp
    from repro.api import Database as JDatabase
    from repro.api import SearchConfig as JConfig
    from repro.core.classify import classification_accuracy as j_accuracy
    from repro.data.synthetic import cylinder_bell_funnel

    spec = importlib.util.spec_from_file_location(
        "classify_timeseries_torch", ROOT / "examples" / "classify_timeseries_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.main("cpu")
    out = capsys.readouterr().out
    rng = np.random.default_rng(0)
    train_x, train_y = cylinder_bell_funnel(rng, 6)
    test_x, test_y = cylinder_bell_funnel(rng, 10)
    w = train_x.shape[1] // 10
    want = {4: j_accuracy(test_x, test_y, train_x, train_y, w=w, p=4)}
    for name, p in ((1, 1), (2, 2), ("inf", jnp.inf)):
        pred = JDatabase.build(train_x, JConfig(w=w, p=p)).classify(train_y, test_x)
        want[name] = float(np.mean(pred == test_y))
    assert got == want
    assert "DTW_4: accuracy" in out and "on the CPU's plain versions" in out


SERVICE_LINE = re.compile(r"^query (\d+) \[(\w+)\]: nn=#(\d+) dist=([0-9.]+) "
                          r"dtw_lanes= *(\d+) pruned=([0-9.]+)% lanes=\d+ wait=[0-9.]+ms$")


def test_search_service_twin_matches_reference():
    """examples/search_service_torch.py over 8 gloo ranks on the CPU and
    examples/search_service.py over 8 host devices, side by side: each
    query's ``nn``, ``dist``, ``dtw_lanes`` and ``pruned`` equal (``lanes``
    and ``wait`` follow timing), and the twin's bit-equality asserts
    against the single-device scan pass."""
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    port = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "search_service_torch.py"), "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ref_out = run_in_subprocess((ROOT / "examples" / "search_service.py").read_text(), 8,
                                    {"JAX_PLATFORMS": "cpu"})
        port_out, port_err = port.communicate(timeout=300)
    finally:
        if port.poll() is None:
            port.kill()
            port.communicate()
    assert port.returncode == 0, port_out + port_err

    def rows(out):
        found = [SERVICE_LINE.match(ln) for ln in out.splitlines() if ln.startswith("query ")]
        assert len(found) == 10 and all(found), out
        return {int(m.group(1)): m.group(2, 3, 4, 5, 6) for m in found}

    assert rows(port_out) == rows(ref_out)
    assert "mesh {'data': 2, 'model': 4}, db 2048 series" in port_out.splitlines()
    assert "driver: sharded (repro_torch.core.distributed.sharded_nn_search)" in port_out
    last = port_out.strip().splitlines()[-1]
    assert last.startswith("served 10 queries from 2 tenants") and last.endswith(
        "all answers match the single-device scan.")


def test_cli_parse_p():
    assert t_cli._parse_p("inf") == math.inf and t_cli._parse_p("2") == 2
    assert t_cli._parse_p("Infinity") == j_cli._parse_p("Infinity")
    with pytest.raises(ValueError, match="positive norm order"):
        t_cli._parse_p("-1")


def test_quickstart_twin_runs_on_cpu(capsys):
    """examples/quickstart_torch.py end to end at 1,100 x 64: above
    SMALL_DB_ROWS, so its batched search takes the host driver as at
    the full 2,000 rows; its exactness asserts run."""
    assert 1100 >= SMALL_DB_ROWS
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(1100, 64, "cpu")
    out = capsys.readouterr().out
    assert "all three methods agree" in out
    assert "driver: host" in out
    assert "facade results identical" in out and "zero rebuild" in out
