"""Triangle counting and the segmented intersection of the PyTorch port
against the JAX package, on graphs both packages build from one seed:
``gtt.tc`` (total, per-edge and per-vertex counts, the chunking),
``row_probe`` and one ``intersect_counts`` chunk on the live lanes,
``cpu_tc``, the ``tc`` CLI and the seven raw-CSR ``api`` functions. The
JAX side runs on the CPU, as ``tests/test_tc.py`` runs it.

Tolerances: counts, ids, labels and distances are exact; the float sums
of the ``api``'s PageRank and BC carry the tolerances of
``tests/test_torch_pr.py`` and ``tests/test_torch_bc.py``."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu import api as japi
from gunrock_tpu.ops import intersection as jint
from gunrock_tpu.utils.reference import cpu_tc as jax_cpu_tc
from gunrock_tpu_torch import api as tapi
from gunrock_tpu_torch import cli
from gunrock_tpu_torch.ops import intersection as tint
from gunrock_tpu_torch.utils.reference import cpu_tc

# the packages' models/__init__ rebind "tc" to the function
jtc = importlib.import_module("gunrock_tpu.models.tc")
ttc = importlib.import_module("gunrock_tpu_torch.models.tc")


def _grid(mod, n):
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return mod.from_coo(n * n, src, dst, undirected=True)


def _k4(mod):
    src, dst = zip(*[(i, j) for i in range(4) for j in range(4) if i < j])
    return mod.from_coo(4, np.array(src), np.array(dst), undirected=True)


SMALL = {
    # one triangle and a pendant vertex
    "triangle": lambda m: m.from_coo(4, np.array([0, 1, 2, 2]),
                                     np.array([1, 2, 0, 3]),
                                     undirected=True),
    "k4": _k4,
    "triangle_free": lambda m: _grid(m, 8),
}


def _assert_tc_equal(got, want):
    assert got.total == want.total
    np.testing.assert_array_equal(got.edge_counts, want.edge_counts)
    np.testing.assert_array_equal(got.vertex_counts, want.vertex_counts)
    for key in ("num_triangles", "num_chunks", "wedges_probed",
                "edges_visited", "num_vertices", "num_edges"):
        assert got.info[key] == want.info[key], key
    assert int(got.vertex_counts.sum()) == 3 * got.total
    assert int(got.edge_counts.sum()) == got.total


@pytest.mark.parametrize("name", sorted(SMALL))
def test_tc_small_graphs_equal_jax(name):
    want = jtc.tc(SMALL[name](gt))
    got = gtt.tc(SMALL[name](gtt), device="cpu")
    _assert_tc_equal(got, want)
    assert got.total == {"triangle": 1, "k4": 4, "triangle_free": 0}[name]


@pytest.mark.parametrize("scale", [8, 9, 10, 11])
def test_tc_rmat_equals_jax(scale):
    gj = gt.io.rmat(scale=scale, edge_factor=8, seed=scale, undirected=True)
    gp = gtt.io.rmat(scale=scale, edge_factor=8, seed=scale, undirected=True)
    got = gtt.tc(gp, device="cpu")
    _assert_tc_equal(got, jtc.tc(gj))
    assert got.total > 0 and got.info["num_chunks"] == 1


def test_tc_directed_input_equals_jax():
    """``undirected_input=False`` symmetrizes a directed graph first."""
    gj = gt.io.rmat(scale=9, edge_factor=8, seed=5)
    gp = gtt.io.rmat(scale=9, edge_factor=8, seed=5)
    got = gtt.tc(gp, undirected_input=False, device="cpu")
    _assert_tc_equal(got, jtc.tc(gj, undirected_input=False))
    assert got.total == cpu_tc(gtt.from_coo(gp.num_nodes, gp.edge_sources(),
                                            gp.col_indices, undirected=True))


@pytest.mark.parametrize("budget", [1, 300, 4096])
def test_tc_chunked_equals_jax(budget, monkeypatch):
    """A small ``GUNROCK_TC_WEDGE_BUDGET`` on both sides: many chunks, the
    JAX package's bounds edge for edge, and the one-chunk counts."""
    gj = gt.io.rmat(scale=9, edge_factor=8, seed=2, undirected=True)
    gp = gtt.io.rmat(scale=9, edge_factor=8, seed=2, undirected=True)
    whole = gtt.tc(gp, device="cpu")
    monkeypatch.setenv("GUNROCK_TC_WEDGE_BUDGET", str(budget))
    jprep, tprep = jtc._tc_prepare(gj), ttc._tc_prepare(gp)
    assert tprep.bounds == jprep.bounds and len(tprep.bounds) > 2
    for f in ("chunk_e", "wedge_cap", "wedge_total", "v_pad"):
        assert getattr(tprep, f) == getattr(jprep, f), f
    for f in ("row", "col", "esrc_pad", "esrc_full"):
        np.testing.assert_array_equal(getattr(tprep, f), getattr(jprep, f))
    got = gtt.tc(gp, device="cpu")
    _assert_tc_equal(got, jtc.tc(gj))
    assert got.info["num_chunks"] == len(tprep.bounds) - 1
    np.testing.assert_array_equal(got.edge_counts, whole.edge_counts)
    np.testing.assert_array_equal(got.vertex_counts, whole.vertex_counts)


def _prep_pair(scale=9, seed=4):
    gj = gt.io.rmat(scale=scale, edge_factor=8, seed=seed, undirected=True)
    return jtc._tc_prepare(gj)


def test_row_probe_equals_jax():
    prep = _prep_pair()
    rng = np.random.default_rng(0)
    n = 4096
    u = rng.integers(0, prep.dag.num_nodes, n).astype(np.int32)
    w = rng.integers(0, prep.dag.num_nodes, n).astype(np.int32)
    # half the probes on real edges
    e = rng.integers(0, prep.dag.num_edges, n // 2)
    u[: n // 2], w[: n // 2] = prep.esrc_full[e], prep.col[e]
    steps = int(np.ceil(np.log2(np.diff(prep.row).max() + 1)))
    want = np.asarray(jint.row_probe(jnp.asarray(prep.row),
                                     jnp.asarray(prep.col), jnp.asarray(u),
                                     jnp.asarray(w), steps))
    got = tint.row_probe(torch.from_numpy(prep.row),
                         torch.from_numpy(prep.col), torch.from_numpy(u),
                         torch.from_numpy(w), steps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[: n // 2].all()


def test_intersect_counts_chunk_equals_jax():
    """One chunk of a many-chunk prep: the JAX function's live lanes
    (``num_edges`` of ``chunk_e``) and the port's exact-size output, with
    the JAX package's padded edge stream on both sides."""
    gj = gt.io.rmat(scale=10, edge_factor=8, seed=4, undirected=True)
    prep = jtc._tc_prepare(gj, wedge_budget=5000)
    a, b = prep.bounds[2], prep.bounds[3]
    csrc = np.zeros(prep.chunk_e, np.int32)
    cdst = np.zeros(prep.chunk_e, np.int32)
    csrc[: b - a] = prep.esrc_full[a:b]
    cdst[: b - a] = prep.col[a:b]
    jc, jv, jw = jax.jit(jint.intersect_counts,
                         static_argnames="wedge_cap")(
        jnp.asarray(prep.row), jnp.asarray(prep.col),
        jnp.asarray(prep.esrc_pad), jnp.asarray(csrc), jnp.asarray(cdst),
        jnp.int32(b - a), wedge_cap=prep.wedge_cap)
    t = torch.from_numpy
    counts, vcounts, wedges = tint.intersect_counts(
        t(prep.row), t(prep.col), t(prep.esrc_pad), t(csrc[: b - a]),
        t(cdst[: b - a]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc)[: b - a])
    np.testing.assert_array_equal(vcounts.numpy(), np.asarray(jv))
    assert wedges == int(jw) and counts.sum() > 0
    assert counts.dtype == torch.int32 and vcounts.dtype == torch.int64


def test_cpu_tc_equals_jax():
    for scale, seed in ((7, 0), (9, 1)):
        gj = gt.io.rmat(scale=scale, edge_factor=8, seed=seed,
                        undirected=True)
        gp = gtt.io.rmat(scale=scale, edge_factor=8, seed=seed,
                         undirected=True)
        assert cpu_tc(gp) == jax_cpu_tc(gj) > 0


def test_tc_cli_matches_jax_cli(capsys, tmp_path):
    """The JAX and port CLIs on the same argv (the port's on the CPU):
    equal validation lines and equal Info counts."""
    from gunrock_tpu import cli as jax_cli
    argv = ["tc", "rmat", "--rmat_scale=9", "--rmat_seed=3", "--undirected"]
    lines, infos = [], []
    for main, extra, name in ((jax_cli.main, [], "jax"),
                              (cli.main, ["--device=cpu"], "port")):
        out = tmp_path / f"{name}.json"
        assert main(argv + extra + [f"--jsonfile={out}"]) == 0
        lines.append([line for line in capsys.readouterr().out.splitlines()
                      if "validation:" in line])
        infos.append(json.loads(out.read_text()))
    assert lines[0] == lines[1] == ["tc validation: CORRECT"]
    want, got = infos
    for key in ("num_triangles", "num_chunks", "wedges_probed",
                "edges_visited", "num_vertices", "num_edges"):
        assert got[key] == want[key], key
    assert got["num_triangles"] > 0


@pytest.fixture(scope="module")
def csr():
    g = gtt.io.rmat(scale=9, edge_factor=8, seed=6, undirected=True)
    g.random_edge_values(seed=2)
    return g.num_nodes, g.row_offsets, g.col_indices, g.edge_values


API_CASES = ["bfs", "sssp", "bc", "cc", "pagerank", "tc", "topk"]


@pytest.mark.parametrize("name", API_CASES)
def test_api_equals_jax(csr, name):
    n, row, col, vals = csr
    if name == "bfs":
        for kw in ({}, {"mark_preds": True, "direction_optimized": True}):
            want = japi.bfs(n, row, col, 3, **kw)
            got = tapi.bfs(n, row, col, 3, device="cpu", **kw)
            for a, b in zip(np.atleast_2d(got), np.atleast_2d(want)):
                np.testing.assert_array_equal(a, b)
    elif name == "sssp":
        want = japi.sssp(n, row, col, vals, 3, mark_preds=True)
        got = tapi.sssp(n, row, col, vals, 3, mark_preds=True, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    elif name == "bc":
        np.testing.assert_allclose(tapi.bc(n, row, col, 3, device="cpu"),
                                   japi.bc(n, row, col, 3), rtol=1e-4,
                                   atol=1e-4)
    elif name == "cc":
        comp, count = tapi.cc(n, row, col, device="cpu")
        wcomp, wcount = japi.cc(n, row, col)
        assert count == wcount
        np.testing.assert_array_equal(comp, wcomp)
    elif name == "pagerank":
        ids, ranks = tapi.pagerank(n, row, col, device="cpu")
        wids, wranks = japi.pagerank(n, row, col)
        np.testing.assert_allclose(ranks, wranks, rtol=1e-4, atol=2e-7)
        assert sorted(ids.tolist()) == list(range(n))
        assert (np.diff(ranks) <= 0).all()
    elif name == "tc":
        got = tapi.tc(n, row, col, device="cpu")
        assert got == japi.tc(n, row, col) > 0
    else:
        for k in (1, 10):
            got, want = tapi.topk(n, row, col, k, device="cpu"), \
                japi.topk(n, row, col, k)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


def test_tc_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        gtt.tc(SMALL["k4"](gtt))
