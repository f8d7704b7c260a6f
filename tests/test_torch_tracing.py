"""The port's tracer and always-on figures on the CPU: spans recorded
only inside ``tracing()`` and on the profiler's clock, the span trees of
a ``bfs()`` and an ``sssp()`` call, the counted host reads and relaxed
edges, the timed splits of the run record, and no process started by a
call after a process's first."""

import copy
import subprocess
import time

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gunrock_tpu_torch import enactor as E
from gunrock_tpu_torch.utils import info as info_mod


@pytest.fixture(scope="module")
def rmat():
    g = gtt.io.rmat(scale=10, edge_factor=8, seed=3, undirected=True)
    dg = gtt.to_device(g, with_csc=True, with_blocked_csc=True, device="cpu")
    return g, dg


@pytest.fixture(scope="module")
def grid():
    """A 200 x 200 grid: small wavefronts over hundreds of levels, every
    one a round of the deep micro-loop."""
    idx = np.arange(200 * 200, dtype=np.int32).reshape(200, 200)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    g = gtt.from_coo(idx.size, src, dst, undirected=True)
    return g, gtt.to_device(g, with_csc=True, device="cpu")


@pytest.fixture(scope="module")
def weighted(rmat, grid):
    """The two graphs with edge values, uploaded as ``sssp(mark_preds)``
    needs them."""
    out = {}
    for name, (g, _) in (("rmat", rmat), ("grid", grid)):
        g = copy.copy(g)
        g.random_edge_values(seed=5)
        out[name] = gtt.to_device(g, with_edge_values=True, with_csc=True,
                                  device="cpu")
    return out


def _sssp(dg, src):
    return gtt.sssp(dg, src, mark_preds=True, device="cpu")


def _do_bfs(dg, src):
    return gtt.bfs(dg, src, mark_preds=True, direction_optimized=True,
                   device="cpu")


def test_tracing_off_records_nothing_and_reads_no_clock(rmat, monkeypatch):
    _, dg = rmat
    assert E.span("a") is E.span("b", kind="push")
    with E.span("a") as s:
        s.set(kind="pull")
    with E.tracing() as records:
        pass
    assert records == []

    def no_clock():
        raise AssertionError("a span read the clock with tracing off")
    monkeypatch.setattr(E.time, "time_ns", no_clock)
    res = _do_bfs(dg, 0)
    assert res.info["num_iterations"] > 0


def test_tracing_reads_nothing_from_the_device(rmat):
    """The tracer adds no host read: the counts are the same on and off,
    and so are the answers."""
    _, dg = rmat
    off = _do_bfs(dg, 5)
    with E.tracing() as records:
        on = _do_bfs(dg, 5)
    assert records
    assert on.info["host_reads"] == off.info["host_reads"]
    np.testing.assert_array_equal(on.labels, off.labels)
    np.testing.assert_array_equal(on.preds, off.preds)


@pytest.mark.parametrize("graph", ["rmat", "grid"])
def test_span_tree_of_two_calls(graph, request):
    _, dg = request.getfixturevalue(graph)
    with E.tracing() as records:
        first = _do_bfs(dg, 0)
        second = _do_bfs(dg, 7)
    by_id = {r[0]: r for r in records}
    assert len(by_id) == len(records)
    roots = [r for r in records if r[1] is None]
    assert [r[3] for r in roots] == ["bfs", "bfs"]
    for (id_, parent, query, name, start, end, attrs), res in zip(
            sorted(roots), (first, second)):
        assert query == id_ and start <= end
        mine = [r for r in records if r[2] == id_]
        names = [r[3] for r in mine]
        levels = [r for r in mine if r[3] == "bfs.level"]
        assert len(levels) == res.info["num_iterations"]
        assert {r[6]["kind"] for r in levels} <= {"push", "pull", "micro"}
        assert names.count("bfs.process") == 1
        assert names.count("bfs.fill_preds") == 1
        assert names.count("bfs.copy") == names.count("bfs.record") == 1
        process = next(r for r in mine if r[3] == "bfs.process")
        for r in mine:
            if r[1] is not None:    # inside its parent, in time
                p = by_id[r[1]]
                assert p[4] <= r[4] <= r[5] <= p[5], r
        for r in levels + [r for r in mine if r[3] == "bfs.fill_preds"]:
            assert r[1] == process[0]
        for r in mine:
            if r[3] in ("bfs.process", "bfs.copy", "bfs.record"):
                assert r[1] == id_
    kinds = {r[6]["kind"] for r in records if r[3] == "bfs.level"}
    assert "pull" in kinds if graph == "rmat" else kinds == {"micro"}


@pytest.mark.parametrize("graph", ["rmat", "grid"])
def test_sssp_span_tree(graph, weighted):
    dg = weighted[graph]
    with E.tracing() as records:
        res = _sssp(dg, 3)
    by_id = {r[0]: r for r in records}
    (root,) = [r for r in records if r[1] is None]
    assert root[3] == "sssp" and all(r[2] == root[0] for r in records)
    names = [r[3] for r in records]
    rounds = [r for r in records if r[3] == "sssp.round"]
    assert len(rounds) == res.info["num_iterations"] > 0
    kinds = {r[6]["kind"] for r in rounds}
    assert kinds <= {"push", "pull", "deep"}
    # On the CPU no round pulls (K3 pulls need the card); the grid's
    # small wavefronts run in the deep micro-loop.
    assert kinds == ({"push", "deep"} if graph == "grid" else {"push"})
    for name in ("sssp.process", "sssp.fill_preds", "sssp.copy",
                 "sssp.record"):
        assert names.count(name) == 1, name
    process = next(r for r in records if r[3] == "sssp.process")
    for r in records:
        if r[1] is not None:
            p = by_id[r[1]]
            assert p[4] <= r[4] <= r[5] <= p[5], r
        if r[3] in ("sssp.round", "sssp.fill_preds"):
            assert r[1] == process[0]
        if r[3] in ("sssp.process", "sssp.copy", "sssp.record"):
            assert r[1] == root[0]


def test_sssp_tracing_off_reads_no_clock_and_changes_nothing(
        weighted, monkeypatch):
    dg = weighted["rmat"]
    with E.tracing() as records:
        on = _sssp(dg, 9)
    assert records

    def no_clock():
        raise AssertionError("a span read the clock with tracing off")
    monkeypatch.setattr(E.time, "time_ns", no_clock)
    off = _sssp(dg, 9)
    assert on.info["host_reads"] == off.info["host_reads"]
    np.testing.assert_array_equal(on.distances, off.distances)
    np.testing.assert_array_equal(on.preds, off.preds)


@pytest.mark.parametrize("graph,src", [("rmat", 0), ("grid", 20100)])
def test_sssp_counts_reads_relaxed_edges_and_splits(graph, src, weighted):
    dg = weighted[graph]
    counts = dict(E.COUNTS)
    splits = {k: list(v) for k, v in E.SPLITS.items()}
    runs = [_sssp(dg, src) for _ in range(2)]
    info = runs[0].info
    assert runs[1].info["host_reads"] == info["host_reads"] >= \
        info["num_iterations"] > 0
    assert E.COUNTS["host_reads"] - counts["host_reads"] == \
        2 * info["host_reads"]
    assert E.COUNTS["levels"] - counts["levels"] == \
        2 * info["num_iterations"]
    assert E.COUNTS["edges"] - counts["edges"] == 2 * info["edges_queued"]
    assert info["edges_queued"] >= info["edges_visited"] > 0
    for key in ("process_ms", "copy_ms", "record_ms"):
        assert info[key] >= 0.0, key
    for name in ("sssp.process", "sssp.copy", "sssp.record"):
        assert E.SPLITS[name][0] == splits.get(name, [0])[0] + 2, name


def test_program_span_shares_the_profilers_clock():
    """A profiler range opened inside a program span lies within the
    span's bounds: both are on time.time_ns()."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with E.tracing() as records:
            with E.span("outer"):
                time.sleep(0.002)
                with record_function("inner.range"):
                    torch.ones(1000).sum()
                time.sleep(0.002)
    (_, _, _, name, start, end, _), = records
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner.range"]
    assert name == "outer" and len(inner) == 1
    s = inner[0].start_ns()
    assert start < s and s + inner[0].duration_ns() < end


def test_tracing_is_not_reentrant_and_drops_unclosed_spans():
    with E.tracing() as records:
        with pytest.raises(RuntimeError, match="already open"):
            with E.tracing():
                pass
        outer = E.span("left_open")
        outer.__enter__()
        with E.span("closed", kind="x") as s:
            s.set(more=1)
    outer.__exit__(None, None, None)
    assert [(r[3], r[6]) for r in records] == [("closed",
                                                 {"kind": "x", "more": 1})]
    assert records[0][1] == outer.id
    with E.tracing() as again:
        with E.span("fresh"):
            pass
    assert again[0][1] is None and records[0] not in again


@pytest.mark.parametrize("graph,src", [("rmat", 0), ("rmat", 11),
                                       ("grid", 0), ("grid", 20100)])
def test_host_reads_repeat_and_cover_every_level(graph, src, request):
    _, dg = request.getfixturevalue(graph)
    before = dict(E.COUNTS)
    runs = [_do_bfs(dg, src) for _ in range(3)]
    reads = {r.info["host_reads"] for r in runs}
    assert len(reads) == 1
    (n,) = reads
    iters = runs[0].info["num_iterations"]
    assert n >= iters > 0
    assert E.COUNTS["host_reads"] - before["host_reads"] == 3 * n
    assert E.COUNTS["levels"] - before["levels"] == 3 * iters


def test_host_reads_of_a_push_bfs_without_preds(rmat):
    """Non-DO without the pull2 layout: the push loop alone."""
    g, _ = rmat
    dg = gtt.to_device(g, device="cpu")
    a, b = (gtt.bfs(dg, 3, device="cpu") for _ in range(2))
    assert a.info["host_reads"] == b.info["host_reads"] >= \
        a.info["num_iterations"] > 0


def test_timed_splits_in_the_run_record(rmat):
    g, dg = rmat
    before = {k: list(v) for k, v in E.SPLITS.items()}
    res = _do_bfs(dg, 0)
    for key in ("process_ms", "copy_ms", "record_ms"):
        assert res.info[key] >= 0.0, key
    assert "preprocess_ms" not in res.info
    for name in ("bfs.process", "bfs.copy", "bfs.record"):
        calls = before.get(name, [0, 0.0])[0]
        assert E.SPLITS[name][0] == calls + 1, name
    # An upload inside the call is a split of its own.
    up = gtt.bfs(g, 0, direction_optimized=True, device="cpu")
    assert up.info["preprocess_ms"] > 0.0 and "host_reads" in up.info


def test_only_a_timer_named_by_its_primitive_records_spans_and_splits():
    g = gtt.io.rmat(scale=8, edge_factor=8, seed=1, undirected=True)
    dg = gtt.to_device(g, with_csc=True, device="cpu")
    before = {k: list(v) for k, v in E.SPLITS.items()}
    with E.tracing() as records:
        res = gtt.pagerank(dg, device="cpu")
        plain, named = E.Timer(), E.Timer("prim")
        for timer in (plain, named):
            with timer.time("step_ms"):
                pass
    assert res.info["process_ms"] > 0.0
    assert [r[3] for r in records] == ["prim.step"]
    assert set(plain.splits) == set(named.splits) == {"step_ms"}
    assert set(E.SPLITS) - set(before) == {"prim.step"}
    assert E.SPLITS["prim.step"][0] == 1


def _refuse_processes(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError(f"a process was started: {args[:1]}")
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)


@pytest.mark.parametrize("name", ["bfs", "sssp", "pagerank"])
def test_no_process_started_after_the_first_call(rmat, monkeypatch, name):
    g, dg = rmat
    call = {"bfs": lambda: _do_bfs(dg, 0),
            "sssp": lambda: gtt.sssp(g, 0, device="cpu"),
            "pagerank": lambda: gtt.pagerank(dg, device="cpu")}[name]
    first = call()           # may read the git commit, once a process
    _refuse_processes(monkeypatch)
    again = call()
    assert again.info["git_commit_sha1"] == first.info["git_commit_sha1"]


def test_device_info_of_a_card_starts_no_process(monkeypatch):
    _refuse_processes(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "H")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    got = info_mod.device_info(torch.device("cuda", 0))
    assert got == {"name": "H", "platform": "gpu", "num_devices": 1}
