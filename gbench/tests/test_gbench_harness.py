"""The harness on the CPU at tiny sizes: the result line, faults in the
timed path that must make ``correct`` false, a cell, traffic mix and
metric added as files only (an edge-valued one too), the BFS cells'
draws as they were, and the import rules."""

import ast
import hashlib
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
    if tr["roots"] is not None:
        tr["roots"]["count"] = 8


def tiny_copy(dst):
    """BENCHMARK.json and gbench/ in ``dst``, the configurations cut to
    2**9 vertices and the rooted traffic to 8 roots."""
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


@pytest.mark.parametrize("cell", ["g500s22.bfs", "rgg22.bfs", "g500s22.pr"])
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
    assert all(c["value"] == c["limit"] == 0 for k, c in checks.items()
               if k != "compared")
    if cell == "g500s22.pr":   # the reading the tolerance was set from
        rtol = bench.plugin("reference", "pagerank").RTOL
        assert 0 <= aside["readings"]["rank_rel_err"] < rtol
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

    def fake(dg, *root, **kw):
        calls[0] += 1
        if calls[0] > 1:   # the warm-up answers, the window's do not
            raise RuntimeError("query lost")
        return real(dg, *root, **kw)
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


def _pr_altered(real):
    def fake(dg, **kw):
        r = real(dg, **kw)
        r.ranks[r.node_ids[0]] *= 1.001   # the top rank, still on top
        return r
    return fake


def _pr_short(real):
    def fake(dg, **kw):
        return real(dg, **dict(kw, max_iters=kw["max_iters"] - 1))
    return fake


def _pr_shuffled(real):
    def fake(dg, **kw):
        r = real(dg, **kw)
        r.node_ids = np.random.default_rng(5).permutation(r.node_ids)
        return r
    return fake


def _pr_unchanged(real):
    def fake(dg, **kw):
        r = real(dg, **kw)
        r.ranks[:] = 1.0 / r.ranks.size
        r.node_ids = np.arange(r.ranks.size, dtype=np.int32)
        return r
    return fake


@pytest.mark.parametrize("fault", [_pr_altered, _pr_short, _pr_shuffled,
                                   _pr_unchanged, _raises])
def test_a_broken_whole_graph_entry_is_not_correct(bench, monkeypatch,
                                                   fault):
    """PageRank broken underneath the harness: one rank altered where it
    is produced, an iteration left out, the order shuffled, the state
    returned unchanged, a query that never answers."""
    monkeypatch.setattr(gtt, "pagerank", fault(gtt.pagerank))
    result, _ = run(bench, "g500s22.pr")
    assert result["correct"] is False
    bad = {k: c["value"] for k, c in result["checks"].items()
           if k != "compared" and c["value"] > c["limit"]}
    assert bad


def _bfs_draws(bench, cell, seed):
    """The cell's graph, roots and check sample (offered a fixed stream
    of answers) at ``seed``, as a digest."""
    wl = bench.workload(cell)
    cfg, tr = bench.config(wl["config"]), bench.traffic(wl["traffic"])
    refmod = bench.plugin("reference", tr["reference"])
    undirected = bool(cfg.get("undirected", False))
    graph = harness.make_graph(bench.plugin("graphs", cfg["generator"]),
                               cfg, seed, CPU)
    roots = harness.draw_roots(refmod, cfg, tr, graph, undirected, seed, CPU)
    sample = harness.sample(tr, seed)
    for i in range(3 * len(roots)):
        r = roots[i % len(roots)]
        sample.offer(float((i * 7919) % 101), r, (i, r))
    items = [it[0] for it in sample.items()]
    h = hashlib.sha256()
    for a in (graph["src"], graph["dst"], np.asarray(roots, np.int64),
              np.asarray(items, np.int64)):
        h.update(np.ascontiguousarray(a).tobytes())
    assert "values" not in graph
    return graph["num_nodes"], h.hexdigest()


# Taken on the tree before whole-graph entries and edge values came in.
BFS_DRAWS = {
    ("g500s22.bfs", 2**31 + 11): "b3f64a2689bb037dcba7cc8c9f51f85d"
                                 "db52ae2a1ea10d750c932f7817d16c13",
    ("g500s22.bfs", 7): "aae751b93aa0b863ee8f37349daee53b"
                        "028e48ea81f3ddeee5d4a09ffd78643c",
    ("rgg22.bfs", 2**31 + 11): "89341e0e466a4352791f19d022f28e8d"
                               "6b378eda423166189d653a639e5d67e4",
    ("rgg22.bfs", 7): "b2504b9d2bc8eb23a400db3c1a829d3c"
                      "4f3d2c067e4c2522b703fdfe52b84514",
}


@pytest.mark.parametrize("cell,seed", sorted(BFS_DRAWS))
def test_bfs_cells_draw_as_before(bench, cell, seed):
    """The BFS cells' graphs, roots and check samples at a fixed seed
    are those of the tree before the rootless and edge-valued rules."""
    n, digest = _bfs_draws(bench, cell, seed)
    assert n == 512 and digest == BFS_DRAWS[cell, seed]


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


SSSP_REFERENCE = '''"""Plain SSSP for a test: Bellman-Ford in NumPy.

Edge values resolved as the program's build states it resolves them
(``from_coo``: "optional symmetrization (add reverse edges), row-major
sort, duplicate-edge removal (first value wins), self-loop removal"):
an undirected edge's reversed copy carries its value, and of the copies
of one directed edge, listed as the generated edges and then their
reversals, the first gives the value."""

import numpy as np

LIMITS = {"dist_off": 0}


class Reference:
    def __init__(self, num_nodes, src, dst, *, undirected, device, values):
        n = int(num_nodes)
        s, d = np.asarray(src, np.int64), np.asarray(dst, np.int64)
        w = np.asarray(values, np.float64)
        if undirected:
            s, d, w = np.r_[s, d], np.r_[d, s], np.r_[w, w]
        keep = s != d
        s, d, w = s[keep], d[keep], w[keep]
        _, first = np.unique(s * n + d, return_index=True)
        self.s, self.d, self.w = s[first], d[first], w[first]
        self.n, self.num_edges = n, int(first.size)

    def work(self, rule, roots):
        return [self.num_edges] * len(roots)

    def judge(self, root, answer):
        dist = np.full(self.n, np.inf)
        dist[root] = 0.0
        for _ in range(self.n):
            new = dist.copy()
            np.minimum.at(new, self.d, dist[self.s] + self.w)
            if np.array_equal(new, dist):
                break
            dist = new
        got = np.asarray(answer["distances"], np.float64)
        fin = np.isfinite(dist)
        off = int((np.isfinite(got) != fin).sum())
        off += int((np.abs(got[fin] - dist[fin])
                    > 1e-5 * (1.0 + dist[fin])).sum())
        return {"dist_off": off}
'''


def _sssp_cell(tmp_path):
    """An SSSP cell on a graph with edge values from the seed, added by
    files alone: a configuration, a traffic mix, a reference and the
    BENCHMARK.json entries."""
    bench = tiny_copy(tmp_path)
    g = os.path.join(tmp_path, "gbench")
    cfg = json.load(open(os.path.join(g, "configs",
                                      "graph500-s22-ef16.json")))
    cfg.update(name="tiny-weighted", edge_factor=4,
               edge_values={"rule": "uniform", "lo": 0.0, "hi": 1.0})
    json.dump(cfg, open(os.path.join(g, "configs", "tiny-weighted.json"),
                        "w"))
    tr = json.load(open(os.path.join(g, "traffic", "closed_dobfs.json")))
    tr["upload"]["kwargs"] = {"with_edge_values": True}
    tr["entry"].update(call="gunrock_tpu_torch.sssp", kwargs={},
                       answer=["distances"])
    tr.update(reference="dummy_sssp", work="edges",
              roots={"rule": "nonzero_degree", "count": 4},
              check={"roots": 4})
    tr["trace"]["spans"] = []
    json.dump(tr, open(os.path.join(g, "traffic", "dummy_sssp.json"), "w"))
    with open(os.path.join(g, "reference", "dummy_sssp.py"), "w") as f:
        f.write(SSSP_REFERENCE)
    spec = bench.spec
    spec["configs"].append({"name": "tiny-weighted", "source": "test",
                            "file": "gbench/configs/tiny-weighted.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.sssp", "config": "tiny-weighted",
                              "traffic": "dummy_sssp", "chips": 1,
                              "why": "test"})
    json.dump(spec, open(os.path.join(tmp_path, "BENCHMARK.json"), "w"))
    return harness.Bench(str(tmp_path))


def test_files_alone_add_an_edge_valued_cell(tmp_path, monkeypatch):
    """Edge values drawn from the seed reach the program's build and the
    reference; the answers read correct, and one altered distance in an
    answer reads not correct."""
    bench = _sssp_cell(tmp_path)
    graph = harness.make_graph(bench.plugin("graphs", "kronecker"),
                               bench.config("tiny-weighted"), 2**31 + 11,
                               CPU)
    vals = graph["values"]
    assert vals.dtype == np.float32 and vals.size == graph["src"].size
    assert 0.0 <= vals.min() and vals.max() < 1.0
    result, _ = run(bench, "tiny.sssp")
    assert result["correct"] is True
    assert result["checks"]["dist_off"]["value"] == 0

    real = gtt.sssp

    def altered(dg, src, **kw):
        r = real(dg, src, **kw)
        fin = np.flatnonzero(np.isfinite(r.distances))
        r.distances[fin[np.argmax(r.distances[fin])]] += 0.5
        return r
    monkeypatch.setattr(gtt, "sssp", altered)
    result, _ = run(bench, "tiny.sssp")
    assert result["correct"] is False
    assert result["checks"]["dist_off"]["value"] > 0


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
        "for cell in ('g500s22.bfs', 'rgg22.bfs', 'g500s22.pr'):\n"
        "    r, _ = harness.run_cell(b, cell, 5, 0.2, True,"
        " torch.device('cpu'), 0.0)\n"
        "    assert r['correct']\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        % (ROOT, str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == []


@pytest.mark.parametrize("cell", ["g500s22.bfs", "g500s22.pr", "rgg22.bfs"])
def test_control_tool_reads_not_correct(tmp_path, cell):
    """``tools/control.py`` at a tiny size: each of the reference's
    ``CONTROLS`` is not correct on every seed, and the tool says so by
    its exit code."""
    bench = tiny_copy(tmp_path)
    refmod = bench.plugin("reference",
                          bench.traffic(bench.workload(cell)["traffic"])
                          ["reference"])
    p = subprocess.run([sys.executable, "gbench/tools/control.py",
                        "--workload", cell, "--seeds", "3", str(2**31 + 9),
                        "--device", "cpu"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines()]
    assert [ln["variant"] for ln in lines] == 2 * list(refmod.CONTROLS)
    assert not any(ln["correct"] for ln in lines)
