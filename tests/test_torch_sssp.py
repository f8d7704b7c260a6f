"""The SSSP slice of the PyTorch port against the JAX package: the
``with_blocked_values`` repair, the plain versions of kernels K5-K8
against the Pallas kernels in interpret mode, ``sssp_device`` (bellman,
near-far with the deep micro-loop, the sweep route and its bail-out) and
the non-DO BFS sweep route, on the same inputs made with numpy from a
seed.

Tolerances: distances, predecessors, labels, ids and counts are exact
(every relaxation rounds ``dist[u] + w`` as one float32 add on both
sides, and every route reaches the same fixpoint); sums of the run
reduction differ by accumulation order (the Pallas kernel scans in
float32, the plain version sums in float64), so they carry rtol 1e-5.
The JAX package runs its pull sweeps Gauss-Seidel and the port Jacobi:
the fixpoints are equal, the per-sweep counts are not compared."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu.ops.pallas_kernels as pk
import gunrock_tpu_torch as gtt
from gunrock_tpu.models.pr import pagerank_device as jax_pagerank_device
from gunrock_tpu.ops import pull2 as jpull2
from gunrock_tpu_torch import cli
from gunrock_tpu_torch.enactor import LoopStats
from gunrock_tpu_torch.graph.device import from_numpy
from gunrock_tpu_torch.models.pr import pagerank_device
from gunrock_tpu_torch.ops import kernels as K
from gunrock_tpu_torch.ops import pull2 as P
from test_torch_pr import JAX_FIELDS, _pair

# the packages' models/__init__ rebind "sssp" and "bfs" to the functions
jsssp = importlib.import_module("gunrock_tpu.models.sssp")
tsssp = importlib.import_module("gunrock_tpu_torch.models.sssp")
jbfs = importlib.import_module("gunrock_tpu.models.bfs")
tbfs = importlib.import_module("gunrock_tpu_torch.models.bfs")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid(mod, n):
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return mod.from_coo(n * n, src, dst, undirected=True)


def _random8200(mod):
    """The graph of tests/test_sssp.py:test_sssp_pull_sweeps_mode."""
    rng = np.random.default_rng(21)
    n, m = 8200, 80000
    return mod.from_coo(n, rng.integers(0, n, m), rng.integers(0, n, m),
                        undirected=True)


GRAPHS = {
    "rmat": lambda m: m.io.rmat(scale=10, edge_factor=8, seed=42,
                                undirected=True),
    # big enough (fcap >= 2 * DEEP_CAP) that the deep micro-loop engages
    "road_big": lambda m: _grid(m, 192),
    "random8200": _random8200,
}

_PAIRS = {}


def _carried(name, **flags):
    """One graph as a JAX DeviceGraph and as the port's DeviceGraph on
    the CPU, built from the JAX graph's arrays by from_numpy."""
    key = (name, tuple(sorted(flags.items())))
    if key not in _PAIRS:
        g = GRAPHS[name](gt)
        g.random_edge_values(seed=11)
        dj = gt.to_device(g, with_edge_values=True, **flags)
        fields = {f: np.asarray(getattr(dj, f)) for f in JAX_FIELDS
                  if getattr(dj, f) is not None}
        dp = from_numpy(fields, num_nodes=dj.num_nodes,
                        num_edges=dj.num_edges, v_pad=dj.v_pad,
                        e_pad=dj.e_pad, device="cpu",
                        undirected=dj.undirected,
                        with_blocked_values=dj.has_blocked_values)
        _PAIRS[key] = (dj, dp)
    return _PAIRS[key]


def test_pagerank_on_blocked_values_graph_equals_jax():
    """The repair: a graph uploaded ``with_blocked_values`` alone carries
    the CSC, so PageRank runs on it (the port raised before)."""
    g = gt.io.rmat(scale=12, edge_factor=4, seed=42, undirected=True)
    dj = gt.to_device(g, with_blocked_values=True)
    assert dj.csc_offsets is None and dj.has_pull2
    want, _, wstats = jax_pagerank_device(dj, max_iters=10)
    gp = gtt.io.rmat(scale=12, edge_factor=4, seed=42, undirected=True)
    dp = gtt.to_device(gp, with_blocked_values=True, device="cpu")
    assert dp.has_csc and dp.has_pull2
    got, _, stats = pagerank_device(dp, max_iters=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=1e-9)
    assert stats.iteration == int(wstats.iteration)
    # The JAX graph's fields carry no CSC: from_numpy builds the same one.
    fields = {f: np.asarray(getattr(dj, f)) for f in JAX_FIELDS
              if getattr(dj, f) is not None}
    assert not any(k.startswith("csc_") for k in fields)
    dn = from_numpy(fields, num_nodes=dj.num_nodes, num_edges=dj.num_edges,
                    v_pad=dj.v_pad, e_pad=dj.e_pad, device="cpu",
                    with_blocked_values=True)
    for f in ("csc_offsets", "csc_indices", "csc_edge_dst", "inv_outdeg"):
        assert torch.equal(getattr(dn, f), getattr(dp, f)), f


def test_sssp_graph_carried_from_jax_keeps_its_csc_weights():
    """A JAX SSSP graph (edge values, blocked values, no CSC) goes into
    the port unchanged; the built CSC carries the edge values."""
    g = GRAPHS["random8200"](gt)
    g.random_edge_values(seed=3)
    dj = gt.to_device(g, with_edge_values=True, with_blocked_values=True)
    fields = {f: np.asarray(getattr(dj, f)) for f in JAX_FIELDS
              if getattr(dj, f) is not None}
    dn = from_numpy(fields, num_nodes=dj.num_nodes, num_edges=dj.num_edges,
                    v_pad=dj.v_pad, e_pad=dj.e_pad, device="cpu",
                    with_blocked_values=True)
    gp = GRAPHS["random8200"](gtt)
    gp.random_edge_values(seed=3)
    dp = gtt.to_device(gp, with_edge_values=True, with_csc=True,
                       device="cpu")
    for f in ("csc_offsets", "csc_indices", "csc_edge_dst",
              "csc_edge_values", "edge_values"):
        assert torch.equal(getattr(dn, f), getattr(dp, f)), f


@pytest.mark.parametrize("two", [False, True])
def test_sample_sorted_plain_equals_pallas(two):
    rng = np.random.default_rng(0)
    arr = rng.random(20000).astype(np.float32)
    ids = rng.integers(0, 100, 20000).astype(np.int32)
    pos = np.sort(rng.integers(0, 20000, 9000)).astype(np.int32)
    if two:
        wa, wb = pk.sample_sorted2(jnp.asarray(ids), jnp.asarray(arr),
                                   jnp.asarray(pos), interpret=True)
        ga, gb = K.sample_sorted2(_t(ids), _t(arr), _t(pos))
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        assert ga.dtype == torch.int32 and gb.dtype == torch.float32
    else:
        want = pk.sample_sorted(jnp.asarray(arr), jnp.asarray(pos),
                                interpret=True)
        got = K.sample_sorted(_t(arr), _t(pos).long())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # positions outside the array read 0
    out = K.sample_sorted(_t(arr[:5]), torch.tensor([-1, 0, 4, 5]))
    np.testing.assert_array_equal(out.numpy(), [0, arr[0], arr[4], 0])


def _reduce_case(case, rng):
    """(sd, vals, aux, out_lanes) of the cases of tests/test_pallas.py."""
    if case == "giant":       # one run over several tiles and chunks
        return (np.zeros(12288, np.int32),
                rng.random(12288).astype(np.float32), None, 256)
    m, nv = {"min": (5000, 300), "sum": (9000, 2000),
             "filtered": (20000, 3000), "overflow": (6000, 4000)}[case]
    sd = np.sort(rng.integers(0, nv, m).astype(np.int32))
    vals = rng.random(m).astype(np.float32) * 10
    aux = None
    if case == "filtered":
        aux = (rng.random(nv).astype(np.float32) * 10)[sd]
    return sd, vals, aux, 1000 if case == "overflow" else nv + 200


@pytest.mark.parametrize("case", ["min", "sum", "filtered", "overflow",
                                  "giant"])
def test_reduce_by_dst_sorted_plain_equals_pallas(case):
    rng = np.random.default_rng(abs(hash(case)) % 2**31)
    sd, vals, aux, out_lanes = _reduce_case(case, rng)
    op = "sum" if case == "sum" else "min"
    kw = dict(op=op, out_lanes=out_lanes)
    wid, wval, wcnt = pk.reduce_by_dst_sorted(
        jnp.asarray(sd), jnp.asarray(vals), interpret=True,
        aux=None if aux is None else jnp.asarray(aux), **kw)
    gid, gval, gcnt = K.reduce_by_dst_sorted(
        _t(sd), _t(vals), aux=None if aux is None else _t(aux), **kw)
    assert gcnt.dtype == torch.int32 and gcnt.dim() == 0
    assert int(gcnt) == int(wcnt)
    k = min(int(gcnt), out_lanes)
    if case == "overflow":
        # Count past out_lanes: the JAX kernel's clamped appends leave its
        # lanes undefined; the port keeps the first out_lanes runs.
        assert int(gcnt) > out_lanes
        np.testing.assert_array_equal(gid.numpy(), np.unique(sd)[:k])
        return
    np.testing.assert_array_equal(gid.numpy()[:k], np.asarray(wid)[:k])
    if op == "sum":
        np.testing.assert_allclose(gval.numpy()[:k], np.asarray(wval)[:k],
                                   rtol=1e-5)
    else:
        np.testing.assert_array_equal(gval.numpy()[:k], np.asarray(wval)[:k])


@pytest.mark.parametrize("op,dtype,count", [("min", np.float32, None),
                                            ("add", np.float32, 1500),
                                            ("max", np.float32, 0),
                                            ("set", np.int32, None)])
def test_scatter_sorted_plain_equals_pallas(op, dtype, count):
    rng = np.random.default_rng(7)
    n = 12000
    ids = np.unique(rng.integers(0, n, 3000).astype(np.int32))
    ids = np.concatenate([ids, [n + 5]]).astype(np.int32)  # dropped
    vals = (rng.normal(size=ids.shape[0]) * 10).astype(dtype)
    dense = (rng.normal(size=n) * 10).astype(dtype)
    want = pk.scatter_sorted(jnp.asarray(dense), jnp.asarray(ids),
                             jnp.asarray(vals), count=count, op=op,
                             interpret=True)
    t = _t(dense.copy())
    got = K.scatter_sorted(t, _t(ids), _t(vals), count=count, op=op)
    assert got is t           # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wmode,sweeps", [("add", 16), ("incr", 8),
                                          ("none", 8)])
def test_pull_min_sweeps_plain_fixpoint_equals_pallas(wmode, sweeps):
    rng = np.random.default_rng(11)
    v_pad, m = 4096, 40000
    src, dst = rng.integers(0, v_pad, m), rng.integers(0, v_pad, m)
    w = (rng.random(m) + 0.05).astype(np.float32)
    jg, pg = _pair(np.concatenate([src, dst]), np.concatenate([dst, src]),
                   np.concatenate([w, w]), v_pad)
    if wmode == "none":       # CC's min-label propagation
        init = np.arange(v_pad, dtype=np.float32)
    else:
        init = np.full(v_pad, np.inf, np.float32)
        init[0] = 0.0
    want, wchg = jpull2.pull_min_sweeps(jg, jnp.asarray(init), sweeps=sweeps,
                                        wmode=wmode, interpret=True)
    got, chg = P.pull_min_sweeps_plain(pg, _t(init), sweeps=sweeps,
                                       wmode=wmode)
    # both reached the fixpoint: a zero on an even sweep
    assert 0 in np.asarray(wchg)[0::2] and 0 in chg.numpy()[0::2]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert chg.dtype == torch.int32 and chg.shape == (sweeps,)
    # Jacobi: the wrapper on CPU tensors is the plain version
    again, chg2 = P.pull_min_sweeps(pg, _t(init), sweeps=sweeps, wmode=wmode)
    assert torch.equal(again, got) and torch.equal(chg2, chg)


# (graph, mode, delta_factor): bellman and near-far on the weighted rmat;
# a small delta makes the near bucket drain (bisect); on the grid the
# deep micro-loop runs, and near-far's threshold jumps in it.
SSSP_CASES = [("rmat", "bellman", 32.0), ("rmat", "nearfar", 0.1),
              ("road_big", "bellman", 32.0), ("road_big", "nearfar", 1.0)]


@pytest.mark.parametrize("name,mode,delta_factor", SSSP_CASES)
def test_sssp_equals_jax(name, mode, delta_factor):
    gj, gp = GRAPHS[name](gt), GRAPHS[name](gtt)
    gj.random_edge_values(seed=11)
    gp.random_edge_values(seed=11)
    src = gj.largest_degree_vertex() if name == "rmat" else 0
    small = name == "rmat"
    want = gt.sssp(gj, src, mark_preds=True, mode=mode,
                   delta_factor=delta_factor, instrumented=small)
    got = gtt.sssp(gp, src, mark_preds=True, mode=mode,
                   delta_factor=delta_factor, instrumented=small,
                   device="cpu")
    np.testing.assert_array_equal(got.distances, want.distances)
    np.testing.assert_array_equal(got.preds, want.preds)
    for k in ("search_depth", "num_iterations", "edges_visited", "mode"):
        assert got.info[k] == want.info[k], k
    assert got.info["route"] == mode
    if small:
        for k in ("phase", "frontier", "m_f"):
            assert [r[k] for r in got.info["per_iteration"]] == \
                [r[k] for r in want.info["per_iteration"]], k
        assert got.info["per_iteration_frontier"] == \
            want.info["per_iteration_frontier"]


def test_sweep_route_with_continuation_calls_equals_jax(monkeypatch):
    """Calls of two sweeps from the largest-degree vertex: both packages
    converge on the sweep route, to bitwise equal distances."""
    monkeypatch.setenv("GUNROCK_SSSP_SWEEPS", "2")
    dj, dp = _carried("random8200", with_blocked_values=True)
    assert dj.has_pull2 and dp.has_pull2
    src = int(np.argmax(np.diff(np.asarray(dj.row_offsets))))
    records = []
    want, wpreds, wstats = jsssp.sssp_device(dj, src, instrument=records)
    assert {r["phase"] for r in records} == {"pull_sweeps"}
    got, preds, stats = tsssp.sssp_device(dp, src)
    assert stats.route == "pull_sweeps" and stats.iteration > 2
    assert stats.iteration % 2 == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sweep_routes_bail_out_on_road_big_as_jax(monkeypatch):
    """Both sweep loops bail out on the grid. The port's SSSP fallback
    reaches the near-far fixpoint (equal to the JAX package's on this
    graph, test_sssp_equals_jax); its BFS fallback gives the JAX
    package's labels and preds."""
    monkeypatch.setenv("GUNROCK_BFS_DEEP", "0")   # see test_torch_bfs.py
    # Calls of two sweeps (one setting drives both packages): the first
    # call changes under 5% of V on either side.
    monkeypatch.setenv("GUNROCK_SSSP_SWEEPS", "2")
    monkeypatch.setenv("GUNROCK_BFS_SWEEP_CHUNK", "2")
    dj, dp = _carried("road_big", with_blocked_values=True, with_csc=True)
    assert dj.has_pull2 and dp.has_pull2
    assert jsssp._sssp_pull_sweeps(dj, 0, mark_preds=False, max_iters=None,
                                   instrument=None) is None
    assert tsssp._sssp_pull_sweeps(dp, 0, max_iters=None,
                                   instrument=None) is None
    dist, _, stats = tsssp.sssp_device(dp, 0, delta=300.0)
    assert stats.route == "bailed_to_nearfar"
    want, _, _ = tsssp.sssp_device(dp, 0, mode="nearfar", delta=300.0)
    assert torch.equal(dist, want)
    # BFS: the JAX sweep loop bails too; labels and preds equal
    assert jbfs._bfs_pull_sweeps(dj, 0, mark_preds=False,
                                 max_iters=None) is None
    wl, wp, wst = jbfs.bfs_device(dj, 0, mark_preds=True)
    labels, preds, st = tbfs.bfs_device(dp, 0, mark_preds=True)
    assert st.route == "bailed_to_push"
    np.testing.assert_array_equal(labels.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(wp))
    assert st.iteration == int(wst.iteration)


def test_bfs_sweep_route_converges_as_jax():
    dj, dp = _carried("random8200", with_blocked_values=True, with_csc=True)
    src = 0
    assert jbfs._bfs_pull_sweeps(dj, src, mark_preds=False,
                                 max_iters=None) is not None
    wl, wp, _ = jbfs.bfs_device(dj, src, mark_preds=True)
    labels, preds, stats = tbfs.bfs_device(dp, src, mark_preds=True)
    assert stats.route == "pull_sweeps"
    np.testing.assert_array_equal(labels.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(wp))
    res = gtt.bfs(dp, src, mark_preds=True, device="cpu")
    assert res.info["route"] == "pull_sweeps"
    assert res.info["search_depth"] == int(np.asarray(wl).max())
    # instrumenting, or GUNROCK_BFS_SWEEPS=0, keeps the push loop
    lab2, _, st2 = tbfs.bfs_device(dp, src, instrument=[])
    assert st2.route == "push" and torch.equal(lab2, labels)


def _mid_state(dp, cfg, src, rounds):
    """The port's state after ``rounds`` push rounds from ``src``."""
    st = tsssp._State(
        dist=torch.full((dp.v_pad,), np.inf), frontier=torch.tensor(
            [src], dtype=torch.int32), n=1, m_f=0,
        active=torch.zeros(dp.v_pad, dtype=torch.bool),
        level=np.float32(0), stats=LoopStats())
    st.dist[src] = 0.0
    st.m_f = tsssp._degree_sum(dp, st.frontier)
    for _ in range(rounds):
        tsssp._general_round(dp, cfg, st)
    return st


@pytest.mark.parametrize("rounds", [1, 2])
def test_pull_round_equals_push_round(rounds):
    """The full-pull round (K3 on CUDA; its plain version here) against
    the push round on the same mid-traversal state: the same distances
    and the same ascending next frontier."""
    _, dp = _carried("rmat", with_csc=True)
    src = int(np.argmax(np.diff(dp.row_offsets.numpy())))
    cfg = tsssp._Config(mode="bellman", delta=np.float32(1), fcap=dp.v_pad,
                        caps=(dp.e_pad,), fused=False, pull_thresh=None,
                        rungs=(), max_iters=100)
    push = _mid_state(dp, cfg, src, rounds)
    pull = dataclasses.replace(push, dist=push.dist.clone())
    got = tsssp._pull_relax(dp, cfg, pull)
    want = tsssp._relax(dp, cfg, push, dp.e_pad)
    assert torch.equal(pull.dist, push.dist)
    assert torch.equal(got[0], want[0]) and got[0].shape[0] > 0
    assert got[1:3] == want[1:3] and got[4] == want[4]
    # the pull branch through sssp_device: a zero threshold pulls always
    full = dataclasses.replace(cfg, pull_thresh=0)
    st = _mid_state(dp, full, src, 0)
    while st.n:
        assert tsssp._general_round(dp, full, st) == "pull"
    ref, _, _ = tsssp.sssp_device(dp, src, mode="bellman")
    assert torch.equal(st.dist, ref)


@pytest.mark.parametrize("name,mode", [("rmat", "bellman"),
                                       ("road_big", "nearfar")])
def test_fused_equals_unfused(name, mode):
    """K7 + K8 winner resolution (their plain versions here) against the
    sort-by-(dst, cand) resolution: bitwise equal distances, rounds and
    frontiers."""
    _, dp = _carried(name)
    a, _, sa = tsssp.sssp_device(dp, 0, mode=mode, delta=40.0, fused=False)
    b, _, sb = tsssp.sssp_device(dp, 0, mode=mode, delta=40.0, fused=True)
    assert torch.equal(a, b)
    assert sa.frontier_trace == sb.frontier_trace


def test_sssp_errors_and_device_graph():
    _, dp = _carried("rmat")
    with pytest.raises(ValueError, match="out of range"):
        tsssp.sssp_device(dp, dp.num_nodes)
    with pytest.raises(ValueError, match="mark_preds"):
        tsssp.sssp_device(dp, 0, mark_preds=True)
    with pytest.raises(ValueError, match="edge_values"):
        tsssp.sssp_device(gtt.to_device(GRAPHS["rmat"](gtt), device="cpu"), 0)
    res = gtt.sssp(dp, 3, max_iters=2, device="cpu")
    assert res.info["num_iterations"] == 2 and res.info["route"] == "bellman"


def test_cli_sssp_correct(capsys, tmp_path):
    K.reset_launch_counts()
    out = tmp_path / "info.json"
    rc = cli.main(["sssp", "rmat", "--rmat_scale=10", "--device=cpu",
                   "--mark-pred", "--mode=nearfar", "--instrumented",
                   f"--jsonfile={out}"])
    text = capsys.readouterr().out
    assert rc == 0 and "sssp validation: CORRECT" in text
    assert not any(K.LAUNCHES.values())
