"""The harness on the CPU at tiny sizes: the result line, faults in the
timed path that must make ``correct`` false, a cell, traffic mix and
metric added as files only, and the import rules."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gbench import harness
from conftest import ROOT

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _edit(path, fn):
    with open(path) as f:
        obj = json.load(f)
    fn(obj)
    with open(path, "w") as f:
        json.dump(obj, f)


def _tiny_config(cfg):
    cfg["scale"] = 9
    if "edge_factor" in cfg:   # sparse enough for small components
        cfg["edge_factor"] = 1


def _tiny_traffic(tr):
    tr["roots"]["count"] = 8


def tiny_copy(dst):
    """BENCHMARK.json and gbench/ in ``dst``, the configurations cut to
    2**9 vertices and the traffic to 8 roots."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    g = os.path.join(dst, "gbench")
    shutil.copytree(os.path.join(ROOT, "gbench"), g,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for c in json.load(open(os.path.join(dst, "BENCHMARK.json")))["configs"]:
        _edit(os.path.join(dst, c["file"]), _tiny_config)
    for name in os.listdir(os.path.join(g, "traffic")):
        _edit(os.path.join(g, "traffic", name), _tiny_traffic)
    return harness.Bench(str(dst))


def run(bench, cell, traced=False, seed=2**31 + 11, seconds=0.3):
    return harness.run_cell(bench, cell, seed, seconds, traced, CPU, 0.0)


@pytest.fixture
def bench(tmp_path):
    return tiny_copy(tmp_path)


@pytest.mark.parametrize("cell", ["g500s22.bfs", "rgg22.bfs"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(bench, cell, traced):
    result, aside = run(bench, cell, traced)
    assert list(result) == KEYS, "checks comes last, no other key"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= aside["queries"] >= 1
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    names = {m["name"] for m in bench.metrics(cell, traced)}
    # On the CPU nothing from a device trace or the device's memory.
    assert set(result["metrics"]) <= names
    cpu_only = {"gteps", "setup_s", "build_s", "upload_s",
                "entry_ms_per_query", "query_p95_ms"}
    assert set(result["metrics"]) == names & cpu_only
    for m in result["metrics"].values():
        assert m["value"] > 0
    checks = result["checks"]
    assert checks["compared"]["value"] >= 1
    assert all(c["value"] == 0 for k, c in checks.items() if k != "compared")
    json.dumps(result)


def _altered(real):
    def fake(dg, src, **kw):
        r = real(dg, src, **kw)
        far = int(np.argmax(r.labels))
        r.labels[far] += 1
        return r
    return fake


def _unchanged(real):
    def fake(dg, src, **kw):
        r = real(dg, src, **kw)
        r.labels[:] = -1
        r.labels[src] = 0
        r.preds[:] = -1
        return r
    return fake


def _raises(real):
    calls = [0]

    def fake(dg, src, **kw):
        calls[0] += 1
        if calls[0] > 1:   # the warm-up answers, the window's do not
            raise RuntimeError("query lost")
        return real(dg, src, **kw)
    return fake


def _stops_early(real):
    def fake(dg, src, **kw):
        return real(dg, src, **dict(kw, max_iters=1))
    return fake


@pytest.mark.parametrize("fault", [_altered, _unchanged, _raises,
                                   _stops_early])
@pytest.mark.parametrize("cell", ["g500s22.bfs", "rgg22.bfs"])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, cell, fault):
    """The timed path broken underneath the harness: an answer altered
    where it is produced, a state returned unchanged, a query that never
    answers, a traversal cut short."""
    monkeypatch.setattr(gtt, "bfs", fault(gtt.bfs))
    result, _ = run(bench, cell)
    assert result["correct"] is False
    bad = {k: c["value"] for k, c in result["checks"].items()
           if k != "compared" and c["value"] > c["limit"]}
    assert bad


def test_files_alone_add_a_cell_traffic_and_metric(tmp_path):
    """A cell, a traffic mix and a per-layer metric added by new files
    and BENCHMARK.json entries only; the harness finds them."""
    bench = tiny_copy(tmp_path)
    g = os.path.join(tmp_path, "gbench")
    with open(os.path.join(g, "metrics", "dummy.queries.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.queries))\n")
    tr = json.load(open(os.path.join(g, "traffic", "closed_dobfs.json")))
    tr["entry"]["kwargs"]["direction_optimized"] = False
    json.dump(tr, open(os.path.join(g, "traffic", "dummy_push.json"), "w"))
    spec = bench.spec
    spec["workloads"].append({"name": "g500s22.push", "config":
                              "graph500-s22-ef16", "traffic": "dummy_push",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "dummy.queries", "unit": "queries",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "gteps",
                              "workloads": ["g500s22.push"]})
    json.dump(spec, open(os.path.join(tmp_path, "BENCHMARK.json"), "w"))
    bench = harness.Bench(str(tmp_path))
    result, aside = run(bench, "g500s22.push", traced=True)
    assert result["correct"] is True
    assert result["metrics"]["dummy.queries"]["value"] == aside["queries"]
    result, _ = run(bench, "g500s22.bfs", traced=True)
    assert "dummy.queries" not in result["metrics"]


def test_run_without_program_or_card_prints_no_result(tmp_path):
    tiny_copy(tmp_path)
    p = subprocess.run([sys.executable, "gbench/run.py", "--workload",
                        "g500s22.bfs", "--seed", str(2**31 + 1), "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["gunrock_tpu_torch.models.bfs",
                                      "gunrock_tpu_torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "gunrock_tpu.ops",
                                      "flax", "jaxlib.xla"]) == [
        "flax", "gunrock_tpu", "jax", "jaxlib"]
    with pytest.raises(ValueError):
        harness.resolve("gunrock_tpu.bfs")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    top = os.path.join(ROOT, "gbench", sub)
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_and_the_reference_not_the_program():
    for path in _sources():
        assert harness.forbidden_modules(list(_imports(path))) == [], path
    for path in _sources("reference"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & {"gunrock_tpu_torch", "gunrock_tpu", "jax"}, path


def test_a_whole_run_loads_no_jax(tmp_path):
    """What a run loads, program included, in a fresh interpreter."""
    tiny_copy(tmp_path)
    code = (
        "import sys, json, torch; sys.path.insert(0, %r)\n"
        "from gbench import harness\n"
        "b = harness.Bench(%r)\n"
        "for cell in ('g500s22.bfs', 'rgg22.bfs'):\n"
        "    r, _ = harness.run_cell(b, cell, 5, 0.2, True,"
        " torch.device('cpu'), 0.0)\n"
        "    assert r['correct']\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        % (ROOT, str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == []


@pytest.mark.parametrize("cell", ["g500s22.bfs", "rgg22.bfs"])
def test_control_tool_reads_not_correct(tmp_path, cell):
    """``tools/control.py`` at a tiny size: each control is not correct
    on every seed, and the tool says so by its exit code."""
    tiny_copy(tmp_path)
    p = subprocess.run([sys.executable, "gbench/tools/control.py",
                        "--workload", cell, "--seeds", "3", str(2**31 + 9),
                        "--device", "cpu"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines()]
    assert len(lines) == 4
    assert not any(ln["correct"] for ln in lines)
