"""BFS in the PyTorch port against the JAX package: labels, iteration
counts, edge accounting and the per-level push/pull/deep sequence are
equal, with the deep micro-loop off, at the defaults and at queue
sizings that make the JAX package regrow its queues; predecessors are
valid and equal the JAX package's. Also the port's CLI, and that
importing the port loads no jax."""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu_torch import cli
from gunrock_tpu_torch.models.bfs import bfs_device
from gunrock_tpu_torch.ops import kernels as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid(mod, n):
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return mod.from_coo(n * n, src, dst, undirected=True)


GRAPHS = {
    "rmat": lambda m: m.io.rmat(scale=10, edge_factor=8, seed=42,
                                undirected=True),
    "grid32": lambda m: _grid(m, 32),
    # big enough (v_pad // 4 > 4096) that DO pushes take the small rung:
    # claim dedup and a materialized queue
    "grid192": lambda m: _grid(m, 192),
    "rmat15": lambda m: m.io.rmat(scale=15, edge_factor=8, seed=42,
                                  undirected=True),
    "rmat15_e4": lambda m: m.io.rmat(scale=15, edge_factor=4, seed=3,
                                     undirected=True),
}

# (graph, src, direction_optimized, alpha): default knobs, and a low
# alpha that makes the direction vote push on some levels.
CASES = [
    ("rmat", "largestdegree", True, 15.0),
    ("rmat", 0, True, 15.0),
    ("rmat", "largestdegree", True, 0.05),
    ("rmat", 5, False, 15.0),
    ("grid32", 0, True, 15.0),
    # big-rung pushes that leave the queue unmaterialized, so the next
    # levels vote with the lazy threshold and switch to pull
    ("grid32", 0, True, 0.05),
    ("grid32", 33, False, 15.0),
    ("grid192", 0, True, 0.01),
]


def _check_preds(g, labels, preds, src):
    assert preds[src] == -1 and (preds[labels < 0] == -1).all()
    v = np.nonzero(labels > 0)[0]
    p = preds[v]
    assert (p >= 0).all() and (labels[p] == labels[v] - 1).all()
    rows = g.row_offsets
    for u, w in zip(p, v):
        assert w in g.col_indices[rows[u]:rows[u + 1]]


def _run_both(name, src, do, alpha, regrows=False, **kw):
    if not regrows:
        jax.clear_caches()
    gj, gp = GRAPHS[name](gt), GRAPHS[name](gtt)
    rj = gt.bfs(gj, src, mark_preds=True, direction_optimized=do,
                alpha=alpha, instrumented=True, **kw)
    rp = gtt.bfs(gp, src, mark_preds=True, direction_optimized=do,
                 alpha=alpha, instrumented=True, device="cpu", **kw)
    # Runs that must not regrow: the JAX package's first queue sizing
    # held, so the comparison is of the sizing the caller gave.
    if not regrows:
        assert not rj.info["frontier_overflow"]
    assert rp.info["frontier_overflow"] == rj.info["frontier_overflow"]
    return gp, rj, rp


def _assert_same_run(gp, rj, rp, exact_edges=True):
    np.testing.assert_array_equal(rp.labels, rj.labels)
    for k in ("num_iterations", "search_depth", "edges_visited",
              "per_iteration_frontier", "src"):
        assert rp.info[k] == rj.info[k], k
    if exact_edges:
        assert rp.info["edges_queued"] == rj.info["edges_queued"]
    else:
        # The JAX package sums edges_queued in float32, one rounding an
        # iteration; the port sums exactly.
        tol = rj.info["num_iterations"] * 2.0**-24 * rp.info["edges_queued"]
        assert abs(rp.info["edges_queued"] - rj.info["edges_queued"]) <= tol
    phases = [r["phase"] for r in rp.info["per_iteration"]]
    assert phases == [r["phase"] for r in rj.info["per_iteration"]]
    assert [r["pull"] for r in rp.info["per_iteration"]] == \
        [r["pull"] for r in rj.info["per_iteration"]]
    _check_preds(gp, rp.labels, rp.preds, rp.info["src"])
    # push levels keep the JAX package's winner lane, micro rounds the
    # smallest source and pull levels the last in-neighbour, so the
    # predecessors are the same
    np.testing.assert_array_equal(rp.preds, rj.preds)
    assert rp.info["gpuinfo"]["platform"] == "cpu"
    assert rp.info["engine"] == "gunrock_tpu_torch"
    return phases


@pytest.mark.parametrize("name,src,do,alpha", CASES)
def test_bfs_matches_jax(name, src, do, alpha, monkeypatch):
    # The deep micro-loop off on both sides: these cases cover the push
    # ladder and, on the grids, the pull. The JAX package still labels a
    # push level "deep" where its queue capacity holds the micro-loop
    # rung (models/bfs.py:707,721), and so does the port.
    monkeypatch.setenv("GUNROCK_BFS_DEEP", "0")
    gp, rj, rp = _run_both(name, src, do, alpha)
    phases = _assert_same_run(gp, rj, rp)
    if not do:
        assert set(phases) == {"push"}


# At the defaults on both sides (the micro-loop on, as the JAX package
# has it off a TPU): (graph, src, DO, alpha, bfs keywords, environment,
# the phases expected).
DEFAULT_CASES = {
    "grid192_do": ("grid192", 0, True, 0.01, {}, {}, {"deep"}),
    "grid192": ("grid192", 0, False, 15.0, {}, {}, {"deep"}),
    # v_pad 32768, so fcap reaches 8192 in DO; the hub's degree (3881)
    # fits the rung, then two pulls, then deep again
    "rmat15_do": ("rmat15", "largestdegree", True, 15.0, {}, {},
                  ["deep", "pull", "pull", "deep", "deep"]),
    "grid192_rungs": ("grid192", 0, True, 15.0, {},
                      {"GUNROCK_BFS_DEEP_RUNGS": "512,2048,8192"}, {"deep"}),
    # fcap 5120 holds no rung: push and pull levels
    "grid192_queue_half": ("grid192", 0, True, 15.0, {"queue_sizing": 0.5},
                           {}, {"push", "pull"}),
}


@pytest.mark.parametrize("case", list(DEFAULT_CASES))
def test_bfs_defaults_match_jax(case, monkeypatch):
    name, src, do, alpha, kw, env, want = DEFAULT_CASES[case]
    monkeypatch.delenv("GUNROCK_BFS_DEEP", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    gp, rj, rp = _run_both(name, src, do, alpha, **kw)
    phases = _assert_same_run(gp, rj, rp, exact_edges="queue_sizing" not in kw)
    assert (phases if isinstance(want, list) else set(phases)) == want


# Queue sizings under which the JAX package's first runs overflow, so it
# reruns them with the sizing doubled (models/bfs.py:773-786); the port
# must regrow alike, or its rungs and "deep" labels differ (the labels
# and preds agree either way). Micro-loop at its default: (graph, src,
# DO, alpha, queue_sizing, the phases expected).
REGROW_CASES = {
    "rmat15_ld_0.2": ("rmat15", "largestdegree", False, 15.0, 0.2,
                      {"deep", "push"}),
    "rmat15_ld_0.1": ("rmat15", "largestdegree", False, 15.0, 0.1,
                      {"deep", "push"}),
    "rmat15_v5_0.2": ("rmat15", 5, False, 15.0, 0.2, {"deep", "push"}),
    "rmat15_e4_v7_0.15": ("rmat15_e4", 7, False, 15.0, 0.15,
                          {"deep", "push"}),
    # DO: the hub's single-source step passes its rung (349 edges, rung
    # 327; models/bfs.py:121); at 0.04 it leaves 349 vertices past fcap
    # 128 and no overflow, then pulls
    "rmat_do_ld_0.02": ("rmat", "largestdegree", True, 0.05, 0.02,
                        {"push", "pull"}),
    # DO: at 0.2 the second level's edges pass the rung; at 0.4 that
    # big-rung push leaves 15340 vertices past fcap 3276 and no overflow
    # (:185), then pulls
    "rmat15_do_v5_0.2": ("rmat15", 5, True, 0.0005, 0.2, {"push", "pull"}),
}


@pytest.mark.parametrize("case", list(REGROW_CASES))
def test_bfs_queue_regrowth_matches_jax(case, monkeypatch):
    name, src, do, alpha, sizing, want = REGROW_CASES[case]
    monkeypatch.delenv("GUNROCK_BFS_DEEP", raising=False)
    # the packages' models/__init__ rebinds "bfs" to the function
    tried = {}
    for side in ("gunrock_tpu", "gunrock_tpu_torch"):
        mod = importlib.import_module(f"{side}.models.bfs")
        tried[side] = []

        def spy(*a, _inner=mod.bfs_device, _log=tried[side], **kw):
            _log.append(kw["queue_sizing"])
            return _inner(*a, **kw)
        monkeypatch.setattr(mod, "bfs_device", spy)
    gp, rj, rp = _run_both(name, src, do, alpha, regrows=True,
                           queue_sizing=sizing)
    assert tried["gunrock_tpu_torch"] == tried["gunrock_tpu"]
    assert len(tried["gunrock_tpu"]) > 1, "the JAX run did not regrow"
    assert not rp.info["frontier_overflow"]
    phases = _assert_same_run(gp, rj, rp, exact_edges=False)
    assert rp.info["phase_iterations"] == rj.info["phase_iterations"]
    assert set(phases) == want


def test_micro_round_keeps_the_smallest_source(monkeypatch):
    """Vertex 3 has the parents 1 and 2 at depth 1: a micro round keeps
    the smallest source, the push ladder the highest lane. A grid of
    side 128 (v_pad 16384) makes fcap hold the rung in non-DO mode."""
    n = 128 * 128
    g = gtt.from_coo(n, [0, 0, 1, 2], [1, 2, 3, 3], undirected=True)
    dg = gtt.to_device(g, device="cpu")
    labels, preds, stats = bfs_device(dg, 0, mark_preds=True)
    assert labels[:4].tolist() == [0, 1, 1, 2] and preds[3] == 1
    assert stats.deep_stretches == 1 and stats.iteration == 3
    monkeypatch.setenv("GUNROCK_BFS_DEEP", "0")
    labels, preds, stats = bfs_device(dg, 0, mark_preds=True)
    assert labels[:4].tolist() == [0, 1, 1, 2] and preds[3] == 2
    assert stats.deep_stretches == 0
    # queue_sizing below DEEP_CAP / v_pad leaves no rung
    assert bfs_device(dg, 0, queue_sizing=0.25)[2].deep_stretches == 0


def test_bfs_sequence_has_push_and_pull():
    g = GRAPHS["rmat"](gtt)
    r = gtt.bfs(g, "largestdegree", direction_optimized=True, alpha=0.05,
                instrumented=True, device="cpu")
    phases = [x["phase"] for x in r.info["per_iteration"]]
    assert "push" in phases and "pull" in phases
    assert set(r.info["phase_iterations"]) == {"push", "pull"}
    assert r.preds is None and r.info["m_teps"] > 0


def test_bfs_device_graph_and_errors():
    g = GRAPHS["grid32"](gtt)
    dg = gtt.to_device(g, with_csc=True, device="cpu")
    labels, preds, stats = bfs_device(dg, 0, direction_optimized=True)
    assert labels.shape == (dg.v_pad,) and preds is None
    assert stats.iteration == 63 and labels[:g.num_nodes].max() == 62
    r = gtt.bfs(dg, 0, direction_optimized=True, device="cpu")
    np.testing.assert_array_equal(r.labels, labels[:g.num_nodes].numpy())
    capped = gtt.bfs(dg, 0, max_iters=3, device="cpu")
    assert capped.info["num_iterations"] == 3 and capped.labels.max() == 3
    with pytest.raises(ValueError, match="out of range"):
        gtt.bfs(dg, g.num_nodes, device="cpu")
    with pytest.raises(ValueError, match="with_csc"):
        bfs_device(gtt.to_device(g, device="cpu"), 0,
                   direction_optimized=True)


def test_bfs_device_graph_runs_where_it_lies():
    """A DeviceGraph runs on its own device whatever ``device`` says, as
    the other primitives run one (``gtt.bfs(dg)`` with the default
    ``device="cuda"`` on a graph uploaded to "cuda", which lands on
    cuda:0; the card case is in tests/test_torch_cuda.py)."""
    g = GRAPHS["grid32"](gtt)
    dg = gtt.to_device(g, with_csc=True, device="cpu")
    want = gtt.bfs(g, 0, direction_optimized=True, device="cpu").labels
    for kw in ({}, {"device": "cpu"}, {"device": torch.device("cpu")},
               {"device": "cuda"}):
        np.testing.assert_array_equal(
            gtt.bfs(dg, 0, direction_optimized=True, **kw).labels, want)


def test_bfs_unreachable():
    g = gtt.from_coo(8, [0, 1, 4], [1, 2, 5], undirected=True)
    r = gtt.bfs(g, 0, mark_preds=True, direction_optimized=True,
                device="cpu")
    np.testing.assert_array_equal(r.labels, [0, 1, 2, -1, -1, -1, -1, -1])
    np.testing.assert_array_equal(r.preds, [-1, 0, 1, -1, -1, -1, -1, -1])


def _grid_and_path():
    """A 6 x 6 grid (vertices 0-35) and, apart from it, the path
    36-37-38."""
    idx = np.arange(36).reshape(6, 6)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel(), [36, 37]])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel(), [37, 38]])
    return gtt.from_coo(39, src, dst, undirected=True)


# (graph, src, sizet64, (edges_visited, search_depth) counted by hand)
RECORD_CASES = {
    # 8 vertices under a larger v_pad: the padding's labels are not summed
    "padded": (lambda: gtt.from_coo(8, [0, 1, 4], [1, 2, 5], undirected=True),
               0, None, (4, 2)),
    # directed: vertex 2 has in-edges and no out-edges
    "root_out_degree_0": (lambda: gtt.from_coo(8, [0, 1], [1, 2]), 2, None,
                          (0, 0)),
    "outside_largest": (_grid_and_path, 37, None, (4, 1)),
    # the doubled edge 0-1 counts twice in both out-degrees
    "multigraph": (lambda: gtt.from_coo(6, [0, 0, 0, 1, 1, 2, 3],
                                        [1, 1, 2, 2, 3, 3, 4], dedup=False,
                                        undirected=True), 0, None, (14, 3)),
    # int64 offsets; 900 vertices under v_pad 1024
    "sizet64": (lambda: _grid(gtt, 30), 0, True, (3480, 58)),
}


@pytest.mark.parametrize("do", [False, True])
@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_bfs_run_record_equals_numpy(case, do):
    """``edges_visited`` and ``search_depth``, reduced on the graph's
    device, equal the numpy formula over the host CSR: the out-degree sum
    over reached vertices and the largest label."""
    make, src, sizet64, want = RECORD_CASES[case]
    g = make()
    dg = gtt.to_device(g, with_csc=True, sizet64=sizet64, device="cpu")
    assert dg.v_pad > g.num_nodes
    assert dg.row_offsets.dtype == (torch.int64 if sizet64 else torch.int32)
    r = gtt.bfs(dg, src, mark_preds=True, direction_optimized=do,
                device="cpu")
    deg = np.diff(g.row_offsets.astype(np.int64))
    got = (r.info["edges_visited"], r.info["search_depth"])
    assert got == (int(deg[r.labels >= 0].sum()), int(r.labels.max(initial=0)))
    assert all(type(x) is int for x in got) and got == want


def test_cli_bfs_correct(capsys, tmp_path):
    K.reset_launch_counts()
    out = tmp_path / "info.json"
    rc = cli.main(["bfs", "rmat", "--rmat_scale=9", "--rmat_edgefactor=8",
                   "--undirected", "--direction-optimized",
                   "--src=largestdegree", "--mark-pred", "--device=cpu",
                   "--instrumented", f"--jsonfile={out}"])
    text = capsys.readouterr().out
    assert rc == 0 and "bfs validation: CORRECT" in text
    assert "phases:" in text
    info = json.loads(out.read_text())
    assert info["primitive"] == "bfs" and info["mark_predecessors"]
    assert set(K.LAUNCHES) >= {"pull_reached_words", "bitmask_gather"}
    assert not any(K.LAUNCHES.values())


def test_import_loads_no_jax():
    code = ("import sys, gunrock_tpu_torch, gunrock_tpu_torch.cli; "
            "bad = sorted(m for m in sys.modules "
            "if m in ('jax', 'gunrock_tpu') "
            "or m.startswith(('jax.', 'gunrock_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("level", [1, 2])
def test_pull_step_matches_jax_mid_traversal(level):
    """One pull level from the same mid-traversal labels, on the same
    graph arrays (the JAX DeviceGraph's, carried over by from_numpy)."""
    import jax.numpy as jnp
    from gunrock_tpu.enactor import init_stats
    from gunrock_tpu_torch.enactor import LoopStats
    from gunrock_tpu_torch.graph.device import from_numpy
    # the packages' models/__init__ rebinds "bfs" to the function
    jbfs = importlib.import_module("gunrock_tpu.models.bfs")
    tbfs = importlib.import_module("gunrock_tpu_torch.models.bfs")

    gj = GRAPHS["rmat"](gt)
    dj = gt.to_device(gj, with_csc=True)
    src = gj.largest_degree_vertex()
    full = gt.bfs(gj, src).labels
    labels = np.full(dj.v_pad, -1, np.int32)
    labels[:gj.num_nodes] = np.where(full <= level, full, -1)
    st = jbfs._State(
        labels=jnp.asarray(labels), preds=jnp.zeros((1,), jnp.int32),
        frontier=jnp.zeros((dj.v_pad,), jnp.int32), n=jnp.int32(1),
        m_f=jnp.int32(0), fvalid=jnp.bool_(False), use_pull=jnp.bool_(True),
        unexplored=jnp.float32(0),
        stats=dataclasses.replace(init_stats(), iteration=jnp.int32(level)))
    want = jbfs._pull_step(dj, dj.v_pad, False, st, use_pallas=False)

    dp = from_numpy({f: np.asarray(getattr(dj, f)) for f in
                     ("row_offsets", "col_indices", "csc_offsets",
                      "csc_indices", "csc_edge_dst")},
                    num_nodes=dj.num_nodes, num_edges=dj.num_edges,
                    v_pad=dj.v_pad, e_pad=dj.e_pad, device="cpu")
    state = tbfs._State(labels=torch.from_numpy(labels.copy()), preds=None,
                        frontier=None, n=1, m_f=0, fvalid=False,
                        use_pull=True, stats=LoopStats(iteration=level))
    edges = tbfs._pull_step(dp, state, level + 1)
    np.testing.assert_array_equal(state.labels.numpy(), np.asarray(want[0]))
    assert (state.n, state.m_f, edges) == \
        (int(want[3]), int(want[4]), int(want[6]))
    assert state.n > 0 and not state.fvalid


def _fill_graph(mod):
    """A hub (vertex 299) joined to 0-198, a path 200-219 hung from vertex
    3, vertices 220-298 without edges (empty CSC rows), three copies of
    3-299 and two of 5-6 (a multigraph), and a weight-0 edge 10-11, with
    weights from a seed."""
    hub = 299
    src = [np.full(199, hub), np.array([3] + list(range(200, 219))),
           np.array([3, 3, 5, 10])]
    dst = [np.arange(199), np.arange(200, 220), np.array([hub, hub, 6, 11])]
    src, dst = np.concatenate(src), np.concatenate(dst)
    w = np.random.default_rng(4).uniform(0.1, 1.0, src.shape[0]).astype(
        np.float32)
    w[-1] = 0.0
    return mod.from_coo(300, src, dst, values=w, undirected=True,
                        dedup=False)


@pytest.mark.parametrize("case", ["bfs", "sssp", "dtype", "layout"])
def test_last_hit_rows_on_the_cpu(case):
    """The fills' wrapper routes CPU tensors to the plain version (no
    launch) and gives the JAX package's predecessors for DO-BFS and SSSP
    on a graph with a hub, empty rows, multigraph copies and a weight-0
    edge; it raises on a wrong dtype and on a tensor that is not
    contiguous."""
    gj, gp = _fill_graph(gt), _fill_graph(gtt)
    dg = gtt.to_device(gp, with_csc=True, with_edge_values=True,
                       device="cpu")
    before = K.LAUNCHES["last_hit_rows"]
    if case == "bfs":
        want = gt.bfs(gj, 299, mark_preds=True, direction_optimized=True,
                      alpha=0.5)
        got = gtt.bfs(dg, 299, mark_preds=True, direction_optimized=True,
                      alpha=0.5, device="cpu")
        assert "pull" in [r["phase"] for r in gtt.bfs(
            dg, 299, direction_optimized=True, alpha=0.5, instrumented=True,
            device="cpu").info["per_iteration"]]
        np.testing.assert_array_equal(got.labels, want.labels)
    elif case == "sssp":
        want = gt.sssp(gj, 299, mark_preds=True)
        got = gtt.sssp(dg, 299, mark_preds=True, device="cpu")
        np.testing.assert_array_equal(got.distances, want.distances)
        assert got.distances[11] == got.distances[10]
    if case in ("bfs", "sssp"):
        np.testing.assert_array_equal(got.preds, want.preds)
        assert (got.preds[220:299] == -1).all()
        assert K.LAUNCHES["last_hit_rows"] == before
        return
    labels = torch.zeros(dg.v_pad, dtype=torch.int32)
    dist = torch.zeros(dg.v_pad)
    w = dg.csc_edge_values
    if case == "dtype":
        bad = [(labels.long(), None), (labels.float(), None),
               (dist, w.double()), (dist.double(), w)]
    else:
        bad = [(torch.zeros(2 * dg.v_pad, dtype=torch.int32)[::2], None),
               (dist, torch.zeros(2 * w.shape[0])[::2]),
               (labels[:dg.v_pad - 1], None)]
    for vals, weights in bad:
        with pytest.raises(ValueError):
            K.last_hit_rows(dg, vals, weights)
    assert torch.equal(K.last_hit_rows(dg, labels),
                       K.last_hit_rows_plain(dg, labels))
