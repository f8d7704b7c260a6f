"""The value-pull slice of the PyTorch port against the JAX package:
``pull_reduce2`` / ``pull_power_iters`` (kernels K3/K4; on the CPU their
plain versions) against the Pallas kernels in interpret mode, PageRank on
both routes, HITS and SALSA, the new DeviceGraph arrays, and the CLI.

Tolerances: ``min`` pulls are exact (every f value is rounded the same
way on both sides); sums differ by accumulation order (the Pallas kernel
sums blocked groups, the plain version in float64), so they carry a
relative tolerance, looser for iterated PageRank where the differences
compound."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from gunrock_tpu.graph.device import round_up
from gunrock_tpu.graph.pull2 import build_pull2
from gunrock_tpu.models.pr import pagerank_device as jax_pagerank_device
from gunrock_tpu.ops import pull2 as jpull2
from gunrock_tpu.ops import segment as jseg
from gunrock_tpu_torch import cli
from gunrock_tpu_torch.graph.device import from_numpy
from gunrock_tpu_torch.models.pr import pagerank_device
from gunrock_tpu_torch.ops import kernels as K
from gunrock_tpu_torch.ops import pull2 as P
from gunrock_tpu_torch.ops.segment import row_reduce_sorted
from gunrock_tpu_torch.utils import reference as oracle

JAX_FIELDS = ("row_offsets", "col_indices", "edge_values", "edge_src",
              "csc_offsets", "csc_indices", "csc_edge_values",
              "csc_edge_dst")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(src, dst, w, v_pad, *, n=None, groups=4, block_rows=32,
          span_rows=32):
    """The same COO as a JAX pull-v2 graph (built as tests/test_pull2.py
    builds it) and as a port DeviceGraph on the CPU."""
    n = v_pad if n is None else n
    p2 = build_pull2(src, dst, w, v_pad, groups=groups,
                     block_rows=block_rows, span_rows=span_rows,
                     with_invdeg=True)
    fields = {k: (v if isinstance(v, int) else jnp.asarray(v))
              for k, v in p2.items()}
    jg = JaxDeviceGraph(
        num_nodes=n, num_edges=len(src), v_pad=v_pad,
        e_pad=round_up(max(len(src), 1)),
        row_offsets=jnp.zeros(v_pad + 1, jnp.int32),
        col_indices=jnp.zeros(1, jnp.int32), edge_values=None,
        edge_src=None, csc_offsets=None, csc_indices=None,
        csc_edge_values=None, csc_edge_dst=None, **fields)
    g = gtt.from_coo(n, src, dst, values=w, remove_self_loops=False,
                     dedup=False)
    pg = gtt.to_device(g, with_csc=True, with_edge_values=True,
                       with_blocked_values=True, device="cpu")
    assert pg.v_pad == v_pad and pg.has_pull2
    return jg, pg


def _assert_pull_equal(got, want, op):
    if op == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("op,wmode", [("sum", "none"), ("min", "add"),
                                      ("sum", "mul"), ("min", "incr")])
@pytest.mark.parametrize("groups", [1, 4])
def test_pull_reduce2_plain_equals_pallas(op, wmode, groups):
    rng = np.random.default_rng(abs(hash((op, wmode, groups))) % 2**31)
    v_pad, m = 4096, 20000
    src = rng.integers(0, v_pad, m)
    dst = rng.integers(0, v_pad, m)
    w = rng.random(m).astype(np.float32)
    vals = rng.random(v_pad).astype(np.float32)
    jg, pg = _pair(src, dst, w, v_pad, groups=groups)
    want = np.asarray(jpull2.pull_reduce2(jnp.asarray(vals), jg, op=op,
                                          wmode=wmode, interpret=True))
    got = P.pull_reduce2_plain(_t(vals), pg, op=op, wmode=wmode)
    assert got.dtype == torch.float32 and got.shape == (v_pad,)
    _assert_pull_equal(got.numpy(), want, op)


@pytest.mark.parametrize("op,wmode,weights", [
    ("min", "none", "val"), ("sum", "add", "val"), ("sum", "mul", "wpr"),
    ("min", "incr", "val")])
def test_pull_reduce2_plain_init_and_wpr_equal_pallas(op, wmode, weights):
    rng = np.random.default_rng(3)
    v_pad, m = 4096, 8000
    src = rng.integers(0, v_pad, m)
    dst = rng.integers(0, v_pad, m)
    w = rng.random(m).astype(np.float32)
    vals = rng.random(v_pad).astype(np.float32)
    init = rng.random(v_pad).astype(np.float32)
    jg, pg = _pair(src, dst, w, v_pad)
    want = np.asarray(jpull2.pull_reduce2(
        jnp.asarray(vals), jg, op=op, wmode=wmode, init=jnp.asarray(init),
        weights=weights, interpret=True))
    got = P.pull_reduce2_plain(_t(vals), pg, op=op, wmode=wmode,
                               init=_t(init), weights=weights)
    _assert_pull_equal(got.numpy(), want, op)


def test_pull_reduce2_plain_span_splits_and_straddles():
    """The graph of tests/test_pull2.py that splits blocks by span, runs
    one giant row across blocks and one row across a group boundary."""
    rng = np.random.default_rng(0)
    v_pad = 4096
    src = list(rng.integers(0, v_pad, 3000))
    dst = [7] * 3000
    for d in range(0, v_pad, 97):
        src.append(int(rng.integers(0, v_pad)))
        dst.append(d)
    src += [1023, 1024, 2047, 2048]
    dst += [4095, 4095, 0, 0]
    src, dst = np.array(src), np.array(dst)
    w = rng.random(len(src)).astype(np.float32)
    vals = rng.random(v_pad).astype(np.float32)
    jg, pg = _pair(src, dst, w, v_pad, groups=4, block_rows=8,
                   span_rows=32)
    for op, wmode in (("sum", "none"), ("min", "add")):
        want = np.asarray(jpull2.pull_reduce2(
            jnp.asarray(vals), jg, op=op, wmode=wmode, interpret=True))
        got = P.pull_reduce2_plain(_t(vals), pg, op=op, wmode=wmode)
        _assert_pull_equal(got.numpy(), want, op)


@pytest.mark.parametrize("iters", [5, 7])
def test_pull_power_iters_plain_equals_pallas(iters):
    rng = np.random.default_rng(44)
    n, v_pad, m = 4000, 4096, 30000
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    jg, pg = _pair(src, dst, None, v_pad, n=n)
    d = 0.85
    reset = (1.0 - d) / n
    init = np.where(np.arange(v_pad) < n, 1.0 / n, 0.0).astype(np.float32)
    want, wchg = jpull2.pull_power_iters(
        jg, jnp.asarray(init), iters=iters, damping=d, reset=reset,
        threshold=1e-6, interpret=True)
    got, chg = P.pull_power_iters_plain(pg, _t(init), iters=iters,
                                        damping=d, reset=reset,
                                        threshold=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-9)
    assert chg.dtype == torch.int32
    np.testing.assert_array_equal(chg.numpy(), np.asarray(wchg))


@pytest.fixture(scope="module")
def power_graphs():
    """The graph of test_pagerank_power_path (tests/test_pr_cc.py), built
    by the JAX package and carried into the port by from_numpy."""
    rng = np.random.default_rng(9)
    n, m = 8300, 60000
    g = gt.from_coo(n, rng.integers(0, n, m), rng.integers(0, n, m),
                    undirected=True)
    jg = gt.to_device(g, with_csc=True, with_edge_src=True,
                      with_blocked_values=True)
    assert jg.has_pull2
    fields = {f: np.asarray(getattr(jg, f)) for f in JAX_FIELDS
              if getattr(jg, f) is not None}
    pg = from_numpy(fields, num_nodes=jg.num_nodes, num_edges=jg.num_edges,
                    v_pad=jg.v_pad, e_pad=jg.e_pad, device="cpu",
                    undirected=jg.undirected,
                    with_blocked_values=jg.has_blocked_values)
    assert pg.has_pull2 and pg.has_blocked_values
    return jg, pg


_JAX_PR = {}


def _jax_pr(jg, route, threshold):
    """JAX reference ranks and iteration count, once per (route,
    threshold)."""
    key = (route, threshold)
    if key not in _JAX_PR:
        max_iters = 12 if threshold == 0.0 else 40
        if route == "power":
            rank, _, st = jax_pagerank_device(jg, max_iters=max_iters,
                                              threshold=threshold)
        else:
            os.environ["GUNROCK_PR_POWER"] = "0"
            try:
                rank, _, st = jax_pagerank_device(
                    jg, max_iters=max_iters, threshold=threshold,
                    pallas=False)
            finally:
                del os.environ["GUNROCK_PR_POWER"]
        _JAX_PR[key] = (np.asarray(rank), int(st.iteration))
    return _JAX_PR[key]


@pytest.mark.parametrize("threshold", [0.0, 1e-3])
@pytest.mark.parametrize("route", ["power", "loop", "loop_kernel"])
def test_pagerank_device_routes_equal_jax(power_graphs, route, threshold,
                                          monkeypatch):
    """``loop`` reaches the loop route on the graph marked without the
    pull-v2 layout, ``loop_kernel`` through ``instrument``; either pulls
    through the K3 wrapper once an iteration, the power route never."""
    from gunrock_tpu_torch.models import pr as pr_module
    jg, pg = power_graphs
    want, want_iters = _jax_pr(jg, "power" if route == "power" else "loop",
                               threshold)
    max_iters = 12 if threshold == 0.0 else 40
    pulls = []

    def counted_pull(*args, **kwargs):
        pulls.append(1)
        return P.pull_reduce2(*args, **kwargs)

    monkeypatch.setattr(pr_module, "pull_reduce2", counted_pull)
    if route == "loop":
        pg = dataclasses.replace(pg, has_pull2=False)
    records = [] if route == "loop_kernel" else None
    rank, order, stats = pagerank_device(
        pg, max_iters=max_iters, threshold=threshold, instrument=records)
    assert len(pulls) == (0 if route == "power" else stats.iteration)
    if records is not None:
        assert len(records) == stats.iteration
    n = pg.num_nodes
    np.testing.assert_allclose(rank.numpy()[:n], want[:n], rtol=5e-3,
                               atol=1e-9)
    assert stats.iteration == want_iters
    assert len(stats.frontier_trace) == want_iters
    if threshold == 0.0:
        assert want_iters == 12
    else:
        assert want_iters < 40
    r = rank.numpy()
    assert (np.diff(r[order.numpy()]) <= 0).all()


@pytest.fixture(scope="module")
def rmat_pair():
    def build(m):
        return m.io.rmat(scale=10, edge_factor=8, seed=42, undirected=True)
    return build(gt), build(gtt)


@pytest.mark.parametrize("compensate", [False, True])
def test_pagerank_csr_equals_jax(rmat_pair, compensate):
    """The XLA route. The JAX package differences a float32 running sum
    over all edges, which puts its ranks up to about 1e-7 off the float64
    oracle here; the port accumulates in float64, so it is held to the
    oracle tightly and to the JAX package within that error."""
    gj, gp = rmat_pair
    want = gt.pagerank(gj, compensate=compensate)
    got = gtt.pagerank(gp, compensate=compensate, device="cpu")
    np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-4, atol=2e-7)
    for key in ("num_iterations", "edges_visited", "search_depth"):
        assert got.info[key] == want.info[key], key
    # A vertex whose move lies within that error of the threshold may
    # count on one side only: the per-iteration counts agree to 1% of V.
    np.testing.assert_allclose(got.info["per_iteration_frontier"],
                               want.info["per_iteration_frontier"],
                               atol=0.01 * gp.num_nodes)
    assert sorted(got.node_ids.tolist()) == list(range(gp.num_nodes))
    assert (np.diff(got.ranks[got.node_ids]) <= 0).all()
    if not compensate:
        ref = oracle.cpu_pagerank(gp, 0.85, got.info["num_iterations"],
                                  tol=0.0)
        np.testing.assert_allclose(got.ranks, ref, rtol=1e-5, atol=1e-9)


def test_pagerank_instrumented_records(rmat_pair):
    _, gp = rmat_pair
    res = gtt.pagerank(gp, max_iters=5, threshold=0.0, instrumented=True,
                       device="cpu")
    recs = res.info["per_iteration"]
    assert [r["iteration"] for r in recs] == [1, 2, 3, 4, 5]
    assert [r["updated"] for r in recs] == \
        res.info["per_iteration_frontier"]
    assert "phase_ms" not in res.info


# The JAX package's XLA route sums HITS scores (up to 1) with a float32
# running sum over all edges, up to about 1.2e-5 off the float64 oracle
# on this graph; SALSA's scores are 1/V-scale. The port accumulates in
# float64 and is held to the oracle at rtol 1e-5.
LINK_TOL = {"hits": dict(rtol=1e-4, atol=2e-5),
            "salsa": dict(rtol=1e-4, atol=1e-6)}


@pytest.mark.parametrize("mode", ["norm", "raw"])
def test_hits_equals_jax(rmat_pair, mode):
    gj, gp = rmat_pair
    from gunrock_tpu.models.hits import hits_device as jax_hits_device
    from gunrock_tpu_torch.models.hits import hits_device
    jd = gt.to_device(gj, with_csc=True, with_edge_src=True)
    pd = gtt.to_device(gp, with_csc=True, with_edge_src=True, device="cpu")
    wh, wa = jax_hits_device(jd, 10, mode=mode, src=3)
    gh, ga = hits_device(pd, 10, mode=mode, src=3)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **LINK_TOL["hits"])
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **LINK_TOL["hits"])


def _check_link(prim, g, hubs, auths, want):
    np.testing.assert_allclose(hubs, want.hubs, **LINK_TOL[prim])
    np.testing.assert_allclose(auths, want.auths, **LINK_TOL[prim])
    ref_hub, ref_auth = getattr(oracle, f"cpu_{prim}")(g, 10)
    atol = 1e-9 if prim == "salsa" else 1e-7
    np.testing.assert_allclose(hubs, ref_hub, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(auths, ref_auth, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("prim", ["hits", "salsa"])
def test_link_analysis_csr_equals_jax(rmat_pair, prim):
    gj, gp = rmat_pair
    want = getattr(gt, prim)(gj, max_iters=10)
    got = getattr(gtt, prim)(gp, max_iters=10, device="cpu")
    _check_link(prim, gp, got.hubs, got.auths, want)
    assert got.info["edges_visited"] == want.info["edges_visited"]


@pytest.mark.parametrize("prim", ["hits", "salsa"])
def test_link_analysis_kernel_route_equals_jax(rmat_pair, prim):
    """The JAX package's kernel route (a blocked graph and its reverse
    graph, both updates pulls), with the reverse graph passed: here both
    pulls go through the K3 wrapper's plain version, against the JAX
    package's XLA route on the same graph."""
    gj, gp = rmat_pair
    want = getattr(gt, prim)(gj, max_iters=10)
    pd = gtt.to_device(gp, with_csc=True, with_edge_src=True,
                       with_blocked_values=True, device="cpu")
    rev = pd.reverse()
    np.testing.assert_array_equal(rev.csc_offsets.numpy(),
                                  pd.row_offsets.numpy())
    fn = getattr(gtt.models, f"{prim}_device")
    hub, auth = fn(pd, 10, rev=rev)
    n = gp.num_nodes
    _check_link(prim, gp, hub.numpy()[:n], auth.numpy()[:n], want)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_row_reduce_sorted_equals_jax(op):
    """Sums against the JAX function; min/max (exact) against numpy with
    the JAX function's empty-row identities, which spares the JAX
    function's associative-scan compile (seconds on the CPU)."""
    rng = np.random.default_rng(5)
    deg = rng.integers(0, 6, 300)
    deg[[0, 17, 299]] = 0
    off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    vals = rng.random(int(off[-1]) + 7).astype(np.float32)
    got = row_reduce_sorted(_t(vals), _t(off), op=op)
    if op == "sum":
        want = np.asarray(jseg.row_reduce_sorted(jnp.asarray(vals),
                                                 jnp.asarray(off), op=op))
        # The JAX package's float32 running sum (total about 800) is
        # about 6e-5 off; the port's per-row float64 sums are exact to
        # float32.
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
        ref = np.add.reduceat(np.append(vals[:off[-1]], 0.0).astype(
            np.float64), off[:-1]) * (deg > 0)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
        return
    ints = rng.integers(-50, 50, vals.shape[0]).astype(np.int32)
    fn = np.minimum if op == "min" else np.maximum
    for x, ident in ((vals, np.inf if op == "min" else -np.inf),
                     (ints, np.iinfo(np.int32).max if op == "min"
                      else np.iinfo(np.int32).min)):
        got = row_reduce_sorted(_t(x), _t(off), op=op)
        assert got.dtype == _t(x).dtype
        ref = np.where(deg > 0, fn.reduceat(
            np.append(x[:off[-1]], x[:1]), off[:-1]), ident)
        np.testing.assert_array_equal(got.numpy(), ref.astype(x.dtype))


@pytest.mark.parametrize("flags", [
    dict(with_edge_values=True),
    dict(with_edge_src=True, with_blocked_values=True),
    dict(with_edge_values=True, with_edge_src=True,
         with_blocked_values=True)])
def test_to_device_value_arrays_equal_jax(rmat_pair, flags):
    gj, gp = rmat_pair
    gj.random_edge_values(seed=3)
    gp.random_edge_values(seed=3)
    try:
        dj = gt.to_device(gj, with_csc=True, **flags)
        dp = gtt.to_device(gp, with_csc=True, device="cpu", **flags)
    finally:
        gj.edge_values = gp.edge_values = None
    for f in JAX_FIELDS:
        a = getattr(dj, f)
        b = getattr(dp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert b.dtype == (torch.float32 if "values" in f
                               else torch.int32)
    assert dp.has_blocked_values == dj.has_blocked_values
    assert dp.has_pull2 == dj.has_pull2
    # Every graph with a CSC carries the wpr weights.
    deg = np.diff(gp.row_offsets).astype(np.float64)
    want = np.zeros(dp.v_pad, np.float32)
    want[:gp.num_nodes][deg > 0] = (1.0 / deg[deg > 0]).astype(np.float32)
    np.testing.assert_array_equal(dp.inv_outdeg.numpy(), want)
    assert gtt.to_device(gp, device="cpu").inv_outdeg is None


@pytest.mark.parametrize("n,env", [(5000, None), (5000, "0"), (3000, None),
                                   (9000, None)])
def test_has_pull2_follows_jax_rule(n, env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("GUNROCK_PULL2", env)
    rng = np.random.default_rng(n)
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    dj = gt.to_device(gt.from_coo(n, src, dst), with_blocked_values=True)
    dp = gtt.to_device(gtt.from_coo(n, src, dst), with_blocked_values=True,
                       device="cpu")
    assert dp.has_pull2 == dj.has_pull2
    assert dp.has_blocked_values
    assert not gtt.to_device(gtt.from_coo(n, src, dst),
                             device="cpu").has_pull2


def test_from_numpy_value_fields(power_graphs):
    jg, pg = power_graphs
    fields = {f: np.asarray(getattr(jg, f)) for f in JAX_FIELDS
              if getattr(jg, f) is not None}
    sizes = dict(num_nodes=jg.num_nodes, num_edges=jg.num_edges,
                 v_pad=jg.v_pad, e_pad=jg.e_pad, device="cpu")
    # The TPU layouts are dropped; other unknown keys are refused.
    with_tpu = dict(fields, pv2_src=np.asarray(jg.pv2_src),
                    pv2_pos=np.asarray(jg.pv2_pos))
    dp = from_numpy(with_tpu, **sizes)
    assert not dp.has_blocked_values and not dp.has_pull2
    np.testing.assert_array_equal(dp.inv_outdeg.numpy(),
                                  pg.inv_outdeg.numpy())
    np.testing.assert_array_equal(dp.edge_src.numpy(),
                                  np.asarray(jg.edge_src))
    with pytest.raises(ValueError, match="unknown"):
        from_numpy(dict(fields, inv_deg=np.zeros(3)), **sizes)
    bad = fields["edge_src"].copy()
    bad[3] += 1
    with pytest.raises(ValueError, match="edge_src"):
        from_numpy(dict(fields, edge_src=bad), **sizes)
    ev = np.ones(jg.e_pad, np.float32)
    with pytest.raises(ValueError, match="needs the CSC"):
        from_numpy({"row_offsets": fields["row_offsets"],
                    "col_indices": fields["col_indices"],
                    "csc_edge_values": ev}, **sizes)
    with pytest.raises(ValueError, match="shape"):
        from_numpy(dict(fields, edge_values=ev[:-1]), **sizes)


def test_reverse_swaps_csr_and_csc(power_graphs):
    _, pg = power_graphs
    rev = pg.reverse()
    for a, b in (("row_offsets", "csc_offsets"), ("col_indices", "csc_indices"),
                 ("edge_src", "csc_edge_dst"), ("csc_offsets", "row_offsets"),
                 ("csc_indices", "col_indices"), ("csc_edge_dst", "edge_src")):
        assert getattr(rev, a) is getattr(pg, b), a
    indeg = np.diff(pg.csc_offsets.numpy()).astype(np.float64)
    want = np.where(indeg > 0, 1.0 / np.maximum(indeg, 1), 0.0)
    np.testing.assert_array_equal(rev.inv_outdeg.numpy(),
                                  want.astype(np.float32))
    # Out-edge sums of the graph are in-edge pulls of its reverse.
    x = torch.from_numpy(np.random.default_rng(2).random(
        pg.v_pad).astype(np.float32))
    got = P.pull_reduce2(x, rev)
    want = row_reduce_sorted(x[pg.col_indices.long()], pg.row_offsets,
                             op="sum")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="with_edge_src"):
        gtt.to_device(gtt.from_coo(4, np.array([0]), np.array([1])),
                      with_csc=True, device="cpu").reverse()


@pytest.mark.parametrize("prim", ["pr", "hits", "salsa"])
def test_cli_value_primitives_correct(capsys, tmp_path, prim):
    K.reset_launch_counts()
    out = tmp_path / "info.json"
    rc = cli.main([prim, "rmat", "--rmat_scale=10", "--rmat_edgefactor=8",
                   "--max-iter=20", "--device=cpu", f"--jsonfile={out}"])
    text = capsys.readouterr().out
    assert rc == 0 and f"{prim} validation: CORRECT" in text
    info = json.loads(out.read_text())
    assert info["primitive"] == {"pr": "pagerank"}.get(prim, prim)
    iters = info["num_iterations"] if prim == "pr" else 20
    mult = 1 if prim == "pr" else 2
    assert info["edges_visited"] == mult * info["num_edges"] * iters
    assert not any(K.LAUNCHES.values())


def _pr64_iterations(g, *, damping=0.85, threshold=1e-6, max_iters=50):
    """The PageRank loop's iteration count (normalized, its stop rule: no
    vertex moved more than ``threshold``) in float64."""
    n = g.num_nodes
    esrc = g.edge_sources()
    deg = np.diff(g.row_offsets).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    rank = np.full(n, 1.0 / n)
    for it in range(1, max_iters + 1):
        new = (1.0 - damping) / n + damping * np.bincount(
            g.col_indices, weights=(rank * inv)[esrc], minlength=n)
        moved = int((np.abs(new - rank) > threshold).sum())
        rank = new
        if moved == 0:
            return it
    return max_iters


@pytest.mark.parametrize("seed", range(12))
def test_pagerank_directed_iterations(seed):
    """On directed graphs the JAX package's float32 running-sum
    differencing can move its stop by an iteration (ROADMAP.md queue C,
    C3): the port's count is held to a float64 power iteration's exactly
    and to the JAX count within one; the ranks as in
    ``test_pagerank_csr_equals_jax``."""
    gj, gp = (m.io.rmat(scale=9, edge_factor=8, seed=seed, undirected=False)
              for m in (gt, gtt))
    want = gt.pagerank(gj)
    got = gtt.pagerank(gp, device="cpu")
    it, jit = got.info["num_iterations"], want.info["num_iterations"]
    assert it == _pr64_iterations(gp)
    assert abs(it - jit) <= 1
    np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-4, atol=2e-7)


CLI_ARGVS = {
    "sssp": ["sssp", "rmat", "--rmat_scale=8", "--rmat_seed=3",
             "--random-edge-values"],
    "bfs": ["bfs", "rmat", "--rmat_scale=8", "--traversal-mode=LB"],
    "wtf": ["wtf", "rmat", "--rmat_scale=8", "--alpha=0.3",
            "--src=largestdegree"],
    "topk": ["topk", "rmat", "--rmat_scale=8", "--top-nodes=7"],
}


@pytest.mark.parametrize("prim", list(CLI_ARGVS))
def test_cli_flags_match_jax_cli(prim, capsys, tmp_path):
    """The JAX and port CLIs on the same argv (the port's on the CPU):
    equal validation lines, and equal Info ``search_depth`` and
    ``edges_visited`` where the JAX record has them. With
    ``--random-edge-values`` both seed R-MAT's weights by ``--rmat_seed``
    (ROADMAP.md queue C, C2)."""
    from gunrock_tpu import cli as jax_cli
    argv = CLI_ARGVS[prim]
    lines, infos = [], []
    for main, extra, name in ((jax_cli.main, [], "jax"),
                              (cli.main, ["--device=cpu"], "port")):
        out = tmp_path / f"{name}.json"
        assert main(argv + extra + [f"--jsonfile={out}"]) == 0
        lines.append([line for line in capsys.readouterr().out.splitlines()
                      if "validation:" in line])
        infos.append(json.loads(out.read_text()))
    assert lines[0] == lines[1] == [f"{prim} validation: CORRECT"]
    want, got = infos
    for key in ("search_depth", "edges_visited"):
        if key in want:
            assert got[key] == want[key], key
    if prim == "sssp":
        assert "search_depth" in want
