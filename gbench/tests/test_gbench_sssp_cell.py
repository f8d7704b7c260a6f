"""The SSSP cell's real files through the harness on the CPU at a tiny
size (its result line, faults in the timed path that must make
``correct`` false, its controls through the control tool, a whole run
that loads no jax), and its two per-layer readers on a made-up trace and
made-up counters."""

import collections
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gbench import harness, program_spans as ps, roofline, trace
from conftest import ROOT
from test_gbench_harness import KEYS, _raises, _stops_early, run, tiny_copy
from test_gbench_program_spans import _Program

CELL = "g500s22.sssp"
BENCH = harness.Bench(ROOT)


@pytest.fixture
def bench(tmp_path):
    return tiny_copy(tmp_path)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(bench, traced):
    result, aside = run(bench, CELL, traced)
    assert list(result) == KEYS, "checks comes last, no other key"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= aside["queries"] >= 1
    names = {m["name"] for m in bench.metrics(CELL, traced)}
    # On the CPU nothing from a device trace, the device's memory or the
    # program's process-wide counts (read on the card only).
    cpu_only = {"gteps", "setup_s", "build_s", "upload_s",
                "entry_ms_per_query"}
    assert set(result["metrics"]) == names & cpu_only
    assert names >= ({"k3_relax_roofline", "relaxations_per_edge"}
                     if traced else {"gteps", "peak_mem_gib", "setup_s"})
    checks = result["checks"]
    assert set(checks) == {"failed", "dist_mismatch", "bad_pred",
                           "not_tree", "compared"}
    assert checks["compared"]["value"] >= 1
    assert all(c["value"] == c["limit"] == 0 for k, c in checks.items()
               if k != "compared")
    assert 0 <= aside["readings"]["dist_rel_err"] < 1e-5
    json.dumps(result)


def _altered(real):
    def fake(dg, src, **kw):
        r = real(dg, src, **kw)
        far = int(np.argmax(np.where(np.isfinite(r.distances),
                                     r.distances, -1.0)))
        r.distances[far] = np.nextafter(r.distances[far], np.inf)
        return r
    return fake


def _cycle(real):
    def fake(dg, src, **kw):
        r = real(dg, src, **kw)
        v = int(np.flatnonzero(r.preds >= 0)[-1])
        r.preds[r.preds[v]] = v   # a vertex and its parent, each the other's
        return r
    return fake


def _unchanged(real):
    def fake(dg, src, **kw):
        r = real(dg, src, **kw)
        r.distances[:] = np.inf
        r.distances[src] = 0.0
        r.preds[:] = -1
        return r
    return fake


@pytest.mark.parametrize("fault", [_altered, _cycle, _unchanged, _raises,
                                   _stops_early])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, fault):
    """SSSP broken underneath the harness: one distance an ulp off, a
    vertex and its parent pointed at each other, the state returned
    unchanged, a query that never answers, the rounds cut short."""
    monkeypatch.setattr(gtt, "sssp", fault(gtt.sssp))
    result, _ = run(bench, CELL)
    assert result["correct"] is False
    bad = {k: c["value"] for k, c in result["checks"].items()
           if k != "compared" and c["value"] > c["limit"]}
    assert bad


def test_control_tool_reads_not_correct(tmp_path):
    """``tools/control.py`` at a tiny size: each of the reference's
    ``CONTROLS`` is not correct on every seed."""
    bench = tiny_copy(tmp_path)
    refmod = bench.plugin("reference", "sssp")
    p = subprocess.run([sys.executable, "gbench/tools/control.py",
                        "--workload", CELL, "--seeds", "3", str(2**31 + 9),
                        "--device", "cpu"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines()]
    assert [ln["variant"] for ln in lines] == 2 * list(refmod.CONTROLS)
    assert not any(ln["correct"] for ln in lines)


def test_a_whole_run_loads_no_jax(tmp_path):
    """What a traced run of the cell loads, program and reference
    included, in a fresh interpreter."""
    tiny_copy(tmp_path)
    code = (
        "import sys, json, torch; sys.path.insert(0, %r)\n"
        "from gbench import harness\n"
        "b = harness.Bench(%r)\n"
        "r, _ = harness.run_cell(b, %r, 5, 0.2, True, torch.device('cpu'),"
        " 0.0)\n"
        "assert r['correct']\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        % (ROOT, str(tmp_path), CELL))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == []


def _run(t=None, device="cuda"):
    return harness.Run(workload={}, config={},
                       traffic={"entry": {"call": "gunrock_tpu_torch.sssp"}},
                       device=torch.device(device), spans={}, queries=[],
                       window_s=0.0, memory_peak_bytes=0, trace=t,
                       graph={"num_nodes": 1 << 22, "num_edges": 128 << 20})


def _read(name, run):
    return BENCH.plugin("metrics", name).read(run)


def test_k3_relax_roofline_reads_two_edge_streams():
    """K3 in SSSP's pull rounds: three passes a launch, counted by pass
    2, with the weights a second stream an edge; nothing where no pull
    round ran."""
    k3 = [("void csc_tile_rows_kernel<2048, int>(...)", 0.0, 20.0),
          ("void pull_tiles_kernel<int>(PullArgsT<int>)", 20.0, 1500.0),
          ("void pull_finish_kernel<int>(PullArgsT<int>, FinishArgs)",
           1500.0, 1560.0)]
    other = [("void sample_sorted_kernel<2>(...)", 2000.0, 2100.0),
             ("void at::cuda::cub::DeviceRadixSortOnesweepKernel",
              2100.0, 2400.0)]
    t = trace.Trace(queries=2, window=(0.0, 5000.0), device=k3 * 2 + other,
                    runtime=collections.Counter(), busy_us=3520.0,
                    idle_by_host=[])
    e, n = 128 << 20, 1 << 22
    need = roofline.bound(2 * (4 * 2 * e + 3 * 4 * n))
    assert _read("k3_relax_roofline", _run(t)) == pytest.approx(
        100 * need["bound_ms"] / (2 * 1.560))
    t.device = other
    assert _read("k3_relax_roofline", _run(t)) is None
    assert _read("k3_relax_roofline", _run(None)) is None


def test_relaxations_per_edge(monkeypatch):
    """The relaxed edges over the SSSP calls times the graph's edges;
    nothing off the card, nor from a program without the counter or
    the entry's split (the parent's, or another entry's)."""
    e = 128 << 20
    monkeypatch.setattr(ps, "program", _Program(
        {"host_reads": 9, "levels": 3, "edges": 7 * e},
        {"sssp.process": [2, 0.3]}))
    assert _read("relaxations_per_edge", _run()) == 3.5
    assert _read("relaxations_per_edge", _run(device="cpu")) is None
    for counts, splits in (({"host_reads": 9, "levels": 3},
                            {"sssp.process": [2, 0.3]}),
                           ({"host_reads": 9, "levels": 3, "edges": 5},
                            {"bfs.process": [2, 0.3]}), (None, None)):
        monkeypatch.setattr(ps, "program", _Program(counts, splits))
        assert _read("relaxations_per_edge", _run()) is None
