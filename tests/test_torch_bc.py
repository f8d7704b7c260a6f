"""The BC and CC slice of the PyTorch port against the JAX package: the
plain versions of kernel K9 (``brandes_fwd_levels``/``brandes_bwd_levels``)
against the Pallas kernel in interpret mode, ``bc_device`` on each route
(kernel C, the hybrid with pulls, the CPU push, fused, all sources,
instrumented, a capacity overflow), ``cc_device`` (hooking and the sweeps
route), the numpy oracles and the CLI, on the same inputs made with numpy
from a seed.

Tolerances: labels, component ids and every count are exact. Path counts
are integers, exact in float32 at these sizes, but the K9 comparison
holds them to rtol 1e-5 as sums (the Pallas kernel scans in float32, the
plain version sums in float64); dependencies are sums of quotients in
another order on each side, so they carry rtol 1e-4 (K9, kernel C, the
hybrid with pulls) or 1e-5 (the push routes, which differ only in the
order of a scatter-add). The float64 oracles agree to rtol 1e-9."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu.enactor import capacity_ladder as jax_capacity_ladder
from gunrock_tpu.ops import pull2 as jpull2
from gunrock_tpu.utils import reference as jref
from gunrock_tpu_torch import cli
from gunrock_tpu_torch.enactor import capacity_ladder
from gunrock_tpu_torch.graph.device import from_numpy
from gunrock_tpu_torch.ops import kernels as K
from gunrock_tpu_torch.ops import pull2 as P
from gunrock_tpu_torch.utils import reference as oracle
from test_torch_pr import JAX_FIELDS

# the packages' models/__init__ rebind "bc" and "cc" to the functions
jbc = importlib.import_module("gunrock_tpu.models.bc")
tbc = importlib.import_module("gunrock_tpu_torch.models.bc")
jcc = importlib.import_module("gunrock_tpu.models.cc")
tcc = importlib.import_module("gunrock_tpu_torch.models.cc")


def _random_undirected(mod, n, m, seed):
    """The graph of tests/test_bc_pull2.py: random edges plus a star."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[: n // 4] = 0
    dst[: n // 4] = rng.integers(1, n, n // 4)
    return mod.from_coo(n, src, dst, undirected=True)


def _grid(mod, n):
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return mod.from_coo(n * n, src, dst, undirected=True)


GRAPHS = {
    "rmat": lambda m: m.io.rmat(scale=10, edge_factor=8, seed=42,
                                undirected=True),
    "rmat12": lambda m: m.io.rmat(scale=12, edge_factor=4, seed=5,
                                  undirected=True),
    "grid": lambda m: _grid(m, 32),
    "rmat_directed": lambda m: m.io.rmat(scale=9, edge_factor=4, seed=3,
                                         undirected=False),
    "cycle": lambda m: m.from_coo(5, np.array([0, 1, 2, 3, 4, 0]),
                                  np.array([1, 2, 3, 4, 0, 2]),
                                  undirected=True),
    "random0": lambda m: _random_undirected(m, 4096, 18000, 0),
    "random3": lambda m: _random_undirected(m, 4096, 18000, 3),
}

_PAIRS = {}


def _carried(name, **flags):
    """One graph as a JAX DeviceGraph and as the port's DeviceGraph on
    the CPU, built from the JAX graph's arrays by from_numpy."""
    key = (name, tuple(sorted(flags.items())))
    if key not in _PAIRS:
        dj = gt.to_device(GRAPHS[name](gt), **flags)
        fields = {f: np.asarray(getattr(dj, f)) for f in JAX_FIELDS
                  if getattr(dj, f) is not None}
        dp = from_numpy(fields, num_nodes=dj.num_nodes,
                        num_edges=dj.num_edges, v_pad=dj.v_pad,
                        e_pad=dj.e_pad, device="cpu",
                        undirected=dj.undirected,
                        with_blocked_values=dj.has_blocked_values)
        _PAIRS[key] = (dj, dp)
    return _PAIRS[key]


def _np(x, n):
    return np.asarray(x)[:n]


@pytest.mark.parametrize("seed", [0, 3])
def test_brandes_levels_plain_equals_pallas(seed):
    """Every forward level from vertex 0 in calls of 8, then every ring;
    the wrapper on CPU tensors is the plain version."""
    dj, dp = _carried(f"random{seed}", with_blocked_values=True)
    assert dj.has_pull2 and dp.has_pull2 and dp.undirected
    lab = np.full(dp.v_pad, np.inf, np.float32)
    lab[0] = 0.0
    sig = np.zeros(dp.v_pad, np.float32)
    sig[0] = 1.0
    jl, js = jnp.asarray(lab), jnp.asarray(sig)
    tl, ts = torch.from_numpy(lab), torch.from_numpy(sig)
    d = 1
    while True:
        jl, js, jchg = jpull2.brandes_fwd_levels(dj, jl, js, d0=d, levels=8,
                                                 interpret=True)
        prev = (tl, ts)
        tl, ts, chg = P.brandes_fwd_levels_plain(dp, *prev, d0=d, levels=8)
        again = P.brandes_fwd_levels(dp, *prev, d0=d, levels=8)
        assert all(torch.equal(a, b) for a, b in zip(again, (tl, ts, chg)))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
        np.testing.assert_array_equal(chg.numpy(), np.asarray(jchg))
        assert chg.dtype == torch.int32 and chg.shape == (8,)
        if 0 in chg.tolist():
            depth = d + chg.tolist().index(0) - 1
            break
        d += 8
    assert depth >= 3
    jd = jnp.zeros(dp.v_pad, jnp.float32)
    td = torch.zeros(dp.v_pad)
    t = depth - 1
    while t >= 0:
        n = min(3, t + 1)
        jd, jring = jpull2.brandes_bwd_levels(dj, jl, js, jd, t0=t, levels=n,
                                              interpret=True)
        prev = td
        td, ring = P.brandes_bwd_levels_plain(dp, tl, ts, prev, t0=t,
                                              levels=n)
        again = P.brandes_bwd_levels(dp, tl, ts, prev, t0=t, levels=n)
        assert torch.equal(again[0], td) and torch.equal(again[1], ring)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4)
        np.testing.assert_array_equal(ring.numpy(), np.asarray(jring))
        t -= n


@pytest.mark.parametrize("seed", [0, 3])
def test_bc_pull2_route_equals_jax(seed, monkeypatch):
    dj, dp = _carried(f"random{seed}", with_blocked_values=True)
    n = dp.num_nodes
    want = jbc._bc_pull2(dj, 0)
    records = []
    got = tbc.bc_device(dp, 0, instrument=records)
    bc, sig, lab, stats = got
    assert stats.route == "pull2"
    np.testing.assert_array_equal(lab.numpy()[:n], _np(want[2], n))
    np.testing.assert_allclose(sig.numpy()[:n], _np(want[1], n), rtol=1e-5)
    np.testing.assert_allclose(bc.numpy()[:n], _np(want[0], n), rtol=1e-4,
                               atol=1e-4)
    assert stats.iteration == int(want[3].iteration) == int(lab.max())
    assert stats.edges_queued == float(want[3].edges_queued)
    trace = np.asarray(want[3].frontier_trace)
    assert stats.frontier_trace == trace[trace >= 0].tolist()
    assert {r["phase"] for r in records} == {"forward", "backward"}
    # three levels a call (GUNROCK_BC_LEVELS): the same levels and counts
    monkeypatch.setenv("GUNROCK_BC_LEVELS", "3")
    res = gtt.bc(dp, 0, device="cpu")
    np.testing.assert_allclose(res.bc_values, bc.numpy()[:n] * 0.5,
                               rtol=1e-6)
    np.testing.assert_array_equal(res.labels, lab.numpy()[:n])
    assert res.info["route"] == "pull2"
    assert res.info["search_depth"] == stats.iteration


def _cfg(dp, pallas=False, fused=False, sizing=1.0):
    return tbc._Config(fcap=max(128, int(dp.v_pad * sizing)),
                       caps=tuple(capacity_ladder(
                           max(128, int(dp.e_pad * sizing)))),
                       pallas=pallas, fused=fused,
                       pull_thresh=max(1, min(dp.num_edges // 32, 2**30)))


def test_bc_hybrid_with_pulls_equals_jax(monkeypatch):
    """The CUDA graph's hybrid (pulls through K3, its plain version here)
    against the JAX package's hybrid with Pallas pulls in interpret
    mode."""
    dj, dp = _carried("rmat", with_blocked_values=True)
    n = dp.num_nodes
    src = int(np.argmax(np.diff(np.asarray(dj.row_offsets))))
    want = jbc._bc_jit(dj, jnp.int32(src), fcap=dj.v_pad,
                       caps=tuple(jax_capacity_ladder(dj.e_pad)),
                       pallas=True, interpret=True)
    pulls = []
    pull = tbc.pull_vertex_reduce
    monkeypatch.setattr(tbc, "pull_vertex_reduce",
                        lambda *a, **k: pulls.append(1) or pull(*a, **k))
    bc, sig, lab, stats = tbc._bc_hybrid(dp, src, _cfg(dp, pallas=True))
    assert pulls, "no level pulled"
    np.testing.assert_array_equal(lab.numpy()[:n], _np(want[2], n))
    np.testing.assert_allclose(sig.numpy()[:n], _np(want[1], n), rtol=1e-5)
    np.testing.assert_allclose(bc.numpy()[:n], _np(want[0], n), rtol=1e-4,
                               atol=1e-4)
    assert stats.iteration == int(want[3].iteration)
    assert stats.edges_queued == float(want[3].edges_queued)
    # The all-pull route (instrumented on CUDA) gives the same result.
    records = []
    bc2, sig2, lab2, st2 = tbc._bc_pull(dp, src, records)
    assert torch.equal(lab2, lab) and st2.iteration == stats.iteration
    np.testing.assert_allclose(bc2.numpy(), bc.numpy(), rtol=1e-5, atol=1e-6)
    levels = [(r["phase"], r["level"]) for r in records]
    assert levels == [("forward", d) for d in range(1, st2.iteration + 1)] + \
        [("backward", t) for t in range(st2.iteration - 1, -1, -1)]
    assert records[st2.iteration - 1]["discovered"] == 0


@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_bc_cpu_push_equals_jax(name):
    gj, gp = GRAPHS[name](gt), GRAPHS[name](gtt)
    src = gj.largest_degree_vertex() if name == "rmat" else 0
    want = gt.bc(gj, src, instrumented=True)
    got = gtt.bc(gp, src, instrumented=True, device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_allclose(got.bc_values, want.bc_values, rtol=1e-5,
                               atol=1e-6)
    for k in ("search_depth", "num_iterations", "edges_visited", "src",
              "per_iteration_frontier", "frontier_overflow"):
        assert got.info[k] == want.info[k], k
    assert got.info["route"] == "hybrid"
    for k in ("phase", "level", "frontier"):
        assert [r.get(k) for r in got.info["per_iteration"]] == \
            [r.get(k) for r in want.info["per_iteration"]], k
    np.testing.assert_allclose(got.bc_values, oracle.cpu_bc(gp, src),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_bc_fused_equals_unfused(name):
    """K5 + K7 + K8 (their plain versions here) against the claim-dedup
    push, with and without pulls: equal labels, counts and frontiers."""
    _, dp = _carried(name, with_blocked_values=True)
    for pallas in (False, True):
        a = tbc._bc_hybrid(dp, 0, _cfg(dp, pallas=pallas))
        b = tbc._bc_hybrid(dp, 0, _cfg(dp, pallas=pallas, fused=True))
        assert torch.equal(a[2], b[2]) and torch.equal(a[1], b[1])
        np.testing.assert_allclose(b[0].numpy(), a[0].numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert a[3].frontier_trace == b[3].frontier_trace


def test_bc_all_sources_equals_jax():
    gj, gp = GRAPHS["cycle"](gt), GRAPHS["cycle"](gtt)
    want = gt.bc(gj, -1)
    got = gtt.bc(gp, None, device="cpu")
    np.testing.assert_allclose(got.bc_values, want.bc_values, rtol=1e-6)
    np.testing.assert_allclose(got.bc_values, oracle.cpu_bc(gp, -1),
                               rtol=1e-6)
    assert got.info["src"] == -1 and \
        got.info["edges_visited"] == want.info["edges_visited"]


def test_bc_queue_sizing_overflow_equals_jax():
    """A queue sizing that the first level's edges overflow stops the
    forward phase there, as in the JAX package."""
    gj, gp = GRAPHS["rmat"](gt), GRAPHS["rmat"](gtt)
    src = gj.largest_degree_vertex()
    want = gt.bc(gj, src, queue_sizing=0.01)
    got = gtt.bc(gp, src, queue_sizing=0.01, device="cpu")
    assert got.info["frontier_overflow"] and want.info["frontier_overflow"]
    assert got.info["num_iterations"] == want.info["num_iterations"] == 1
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_allclose(got.bc_values, want.bc_values, rtol=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        gtt.bc(gp, gp.num_nodes, device="cpu")


@pytest.mark.parametrize("name", ["rmat", "grid", "rmat_directed"])
def test_cc_equals_jax(name):
    gj, gp = GRAPHS[name](gt), GRAPHS[name](gtt)
    want = gt.cc(gj, instrumented=True)
    got = gtt.cc(gp, instrumented=True, device="cpu")
    np.testing.assert_array_equal(got.components, want.components)
    assert got.num_components == want.num_components
    for k in ("num_iterations", "per_iteration_frontier", "symmetrized",
              "edges_visited"):
        assert got.info[k] == want.info[k], k
    assert got.info["symmetrized"] == (name == "rmat_directed")
    assert [r["iteration"] for r in got.info["per_iteration"]] == \
        [r["iteration"] for r in want.info["per_iteration"]]
    np.testing.assert_array_equal(got.components, oracle.cpu_cc(gp))


def test_cc_full_edge_pull_equals_hook():
    """The full-edge round as a min pull over in-edges (K3 on CUDA, its
    plain version here) equals the hook over every edge."""
    _, dp = _carried("rmat", with_blocked_values=True, with_edge_src=True)
    stats = tcc.LoopStats()
    comp, _ = tcc._cc_init(dp, stats)
    a = tcc._full_edge_round(dp, comp.clone(), pull=False)
    b = tcc._full_edge_round(dp, comp.clone(), pull=True)
    assert a[1] == b[1] and a[2] == b[2]
    fa, na = tcc._finalize(dp, a[0])
    fb, nb = tcc._finalize(dp, b[0])
    assert torch.equal(fa, fb) and na == nb
    with pytest.raises(ValueError, match="with_edge_src"):
        tcc.cc_device(gtt.to_device(GRAPHS["rmat"](gtt), device="cpu"))


def test_cc_sweeps_route_equals_jax(monkeypatch):
    monkeypatch.setenv("GUNROCK_CC_SWEEPS", "1")
    dj, dp = _carried("rmat12", with_blocked_values=True, with_edge_src=True)
    assert dj.has_pull2 and dp.has_pull2
    wcomp, wn, wstats = jcc.cc_device(dj)
    comp, ncomp, stats = tcc.cc_device(dp)
    assert stats.route == "pull_sweeps"
    np.testing.assert_array_equal(comp.numpy(), np.asarray(wcomp))
    assert ncomp == int(wn)
    # Both stop after the first call here; the per-sweep counts differ
    # (Gauss-Seidel sweeps in the JAX package, Jacobi in the port).
    assert stats.iteration == int(wstats.iteration)
    # instrumenting keeps the hooking route
    comp2, n2, st2 = tcc.cc_device(dp, instrument=[])
    assert st2.route == "hook" and n2 == ncomp
    assert torch.equal(comp2[:dp.num_nodes], comp[:dp.num_nodes])


@pytest.mark.parametrize("name,src", [("rmat", 3), ("grid", 0),
                                      ("cycle", -1)])
def test_oracles_equal_jax(name, src):
    gj, gp = GRAPHS[name](gt), GRAPHS[name](gtt)
    np.testing.assert_allclose(oracle.cpu_bc(gp, src), jref.cpu_bc(gj, src),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(oracle.cpu_cc(gp), jref.cpu_cc(gj))
    if src >= 0:
        labels, sigma, _ = oracle.cpu_brandes(gp, src)
        np.testing.assert_array_equal(labels, oracle.cpu_bfs(gp, src))
        assert sigma[src] == 1.0 and (sigma[labels > 0] >= 1.0).all()


def test_cc_oracle_on_directed_and_isolated():
    gj, gp = GRAPHS["rmat_directed"](gt), GRAPHS["rmat_directed"](gtt)
    np.testing.assert_array_equal(oracle.cpu_cc(gp), jref.cpu_cc(gj))
    g = gtt.from_coo(7, np.array([0, 1, 2, 3, 4, 5]),
                     np.array([1, 2, 0, 4, 5, 3]), undirected=True)
    np.testing.assert_array_equal(oracle.cpu_cc(g), [0, 0, 0, 3, 3, 3, 6])


@pytest.mark.parametrize("prim", ["bc", "cc"])
def test_cli_bc_cc_correct(prim, capsys, tmp_path):
    K.reset_launch_counts()
    out = tmp_path / "info.json"
    rc = cli.main([prim, "rmat", "--rmat_scale=10", "--device=cpu",
                   "--src=largestdegree", "--instrumented",
                   f"--jsonfile={out}"])
    text = capsys.readouterr().out
    assert rc == 0 and f"{prim} validation: CORRECT" in text
    assert not any(K.LAUNCHES.values())
