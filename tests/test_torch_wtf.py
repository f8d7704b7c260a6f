"""WTF and TopK of the PyTorch port against the JAX package and the
float64 oracle ``cpu_wtf``, on the CPU.

Each graph is built from one seed by both packages' R-MAT generators,
whose host CSRs are byte-identical, so no converter carries a graph (or
its weights) across. On R-MAT, vertex 0 is the largest-degree vertex, so
WTF runs from it and from the last vertex with out-edges (degree 1).

Where parity is at risk, and what each test holds:

  * PPR: the JAX package differences a float32 running sum over all
    edges (``row_reduce_sorted``), the port's plain pull sums each row in
    float64, so ranks differ by float32 rounding of the total (about
    1e-7): rtol 1e-4, atol 1e-7.
  * The iteration count: the diff is a float32 sum in another order. At
    ``threshold=0`` it is ``max_iters`` exactly; at the defaults it is
    held within one of the JAX count and equal to a float64 power
    iteration's with the same stop rule.
  * The circle of trust (CoT): two vertices whose PPR lies closer than
    that rounding can swap at rank 1000 and change SALSA's edge set. The
    CoT is held exactly at V <= 1000 (it is every vertex) and at V > 1000
    where the float64 oracle's gap at the cut exceeds 1e-6 (the case
    table says where, and the test asserts it); elsewhere by the sorted
    PPR values of its members.
  * Ties in the top-k selections: both packages put the lower id first.
    ``node_ids`` are held exactly at every rank whose score differs from
    its neighbours' by more than the score tolerance, the scores by
    value.
  * TopK's centralities are integers: ids and values exactly.
"""

import numpy as np
import pytest

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu_torch.graph.device import to_device
from gunrock_tpu_torch.models.topk import topk_device
from gunrock_tpu_torch.ops import kernels as K
from gunrock_tpu_torch.utils.reference import cpu_wtf

PPR_TOL = dict(rtol=1e-4, atol=1e-7)
SCORE_TOL = dict(rtol=1e-4, atol=1e-9)
ORACLE_TOL = dict(rtol=1e-3, atol=1e-6)  # tests/test_link_analysis.py

_GRAPHS = {}


def _pair(undirected, scale, seed):
    key = (undirected, scale, seed)
    if key not in _GRAPHS:
        _GRAPHS[key] = tuple(m.io.rmat(scale=scale, edge_factor=8, seed=seed,
                                       undirected=undirected)
                             for m in (gt, gtt))
    return _GRAPHS[key]


def _cot(ppr, k):
    """The CoT: the top ``k`` by PPR, ties by ascending id."""
    return np.argsort(-ppr, kind="stable")[:k]


def _apart(scores, rtol=SCORE_TOL["rtol"], atol=SCORE_TOL["atol"]):
    """Ranks whose score differs from both neighbours' by more than the
    score tolerance: there the order cannot depend on rounding."""
    s = np.asarray(scores, np.float64)
    gap = np.full(s.shape[0] + 1, np.inf)
    gap[1:-1] = np.abs(np.diff(s))
    return np.minimum(gap[:-1], gap[1:]) > atol + rtol * np.abs(s)


def _ppr64_iterations(g, src, *, delta=0.85, max_iters=50, threshold=1e-6):
    """WTF phase 1's iteration count in float64, with its stop rule."""
    n = g.num_nodes
    esrc, edst = g.edge_sources(), g.col_indices
    deg = np.diff(g.row_offsets).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    rank = np.full(n, 1.0 / n)
    tele = np.zeros(n)
    tele[src] = 1.0 - delta
    diff, it = np.inf, 0
    while diff > threshold and it < max_iters:
        new = delta * np.bincount(edst, weights=(rank * inv)[esrc],
                                  minlength=n) + tele
        diff = np.abs(new - rank).sum()
        rank, it = new, it + 1
    return it


@pytest.mark.parametrize("k", [1, 10, "V"])
@pytest.mark.parametrize("scale", [8, 10, 12])
def test_topk_equals_jax(scale, k):
    gj, gp = _pair(True, scale, scale)
    k = gp.num_nodes if k == "V" else k
    want = gt.topk(gj, k=k)
    got = gtt.topk(gp, k=k, device="cpu")
    np.testing.assert_array_equal(got.node_ids, want.node_ids)
    np.testing.assert_array_equal(got.centralities, want.centralities)
    assert got.node_ids.dtype == got.centralities.dtype == np.int32
    cent = gp.out_degrees + np.bincount(gp.col_indices,
                                        minlength=gp.num_nodes)
    order = np.argsort(-cent, kind="stable")[:k]
    np.testing.assert_array_equal(got.node_ids, order)
    np.testing.assert_array_equal(got.centralities, cent[order])
    assert got.info["top_nodes"] == k and got.info["primitive"] == "topk"


# (undirected, scale, seed): V = 256 (the CoT is every vertex) and
# V = 2048; the directed scale-11 graph of seed 34 is one whose float64
# PPR has a gap above 1e-6 at rank 1000 from vertex 0, at both settings.
WTF_GRAPHS = [(True, 8, 8), (False, 8, 8), (True, 11, 11), (False, 11, 34)]
# (graph, source) pairs whose CoT is held exactly although V > 1000.
COT_EXACT = {((False, 11, 34), "hub")}
SETTINGS = {"fixed": dict(threshold=0.0, max_iters=10), "defaults": {}}


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("source", ["hub", "low"])
@pytest.mark.parametrize("graph", WTF_GRAPHS,
                         ids=["u8", "d8", "u11", "d11"])
def test_wtf_equals_jax_and_oracle(graph, source, setting):
    gj, gp = _pair(*graph)
    src = 0 if source == "hub" else int(np.nonzero(gp.out_degrees)[0][-1])
    if source == "hub":
        assert gp.largest_degree_vertex() == 0
    kw = SETTINGS[setting]
    want = gt.wtf(gj, src, **kw)
    K.reset_launch_counts()
    got = gtt.wtf(gp, src, device="cpu", **kw)
    assert not any(K.LAUNCHES.values())
    n = gp.num_nodes
    cap = min(1000, n)

    # Phase 1: PPR and its iteration count.
    np.testing.assert_allclose(got.ppr_ranks, want.ppr_ranks, **PPR_TOL)
    it, jit = got.info["ppr_iterations"], want.info["ppr_iterations"]
    if setting == "fixed":
        assert it == jit == 10
    else:
        assert abs(it - jit) <= 1
        assert it == _ppr64_iterations(gp, src)
    ref, ppr64 = cpu_wtf(gp, src, **kw)
    np.testing.assert_allclose(got.ppr_ranks, ppr64, **ORACLE_TOL)

    # Phase 2: the CoT.
    cot, jcot = _cot(got.ppr_ranks, cap), _cot(want.ppr_ranks, cap)
    s64 = np.sort(ppr64)[::-1]
    exact = n <= 1000 or (graph, source) in COT_EXACT
    if n > 1000:
        assert (s64[cap - 1] - s64[cap] > 1e-6) == exact
    if exact:
        assert set(cot.tolist()) == set(jcot.tolist())
    else:
        np.testing.assert_allclose(np.sort(got.ppr_ranks[cot]),
                                   np.sort(want.ppr_ranks[jcot]), **PPR_TOL)

    # Phase 3: the ranking, against JAX and the oracle.
    assert got.node_ids.shape == want.node_ids.shape == (cap,)
    assert got.node_ids.dtype == np.int32
    np.testing.assert_allclose(got.scores, want.scores, **SCORE_TOL)
    keep = _apart(got.scores) & _apart(want.scores)
    np.testing.assert_array_equal(got.node_ids[keep], want.node_ids[keep])
    assert (np.diff(got.scores) <= 0).all()
    np.testing.assert_allclose(np.sort(got.scores)[::-1],
                               np.sort(ref)[::-1][:cap], **ORACLE_TOL)
    np.testing.assert_allclose(got.scores, ref[got.node_ids], **ORACLE_TOL)

    # Info.
    for key in ("src", "alpha", "delta"):
        assert got.info[key] == want.info[key], key
    assert got.info["edges_visited"] == gp.num_edges * it
    assert want.info["edges_visited"] == gj.num_edges * jit


def test_wtf_on_a_device_graph_equals_the_csr_route():
    """A DeviceGraph uploaded with_blocked_values (as ``chip_smoke.py``
    passes phase 6's graph) gives the same result as the host graph."""
    _, gp = _pair(False, 11, 34)
    want = gtt.wtf(gp, 0, device="cpu")
    got = gtt.wtf(to_device(gp, with_csc=True, with_blocked_values=True,
                            device="cpu"), 0)
    np.testing.assert_array_equal(got.ppr_ranks, want.ppr_ranks)
    np.testing.assert_array_equal(got.node_ids, want.node_ids)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_wtf_and_topk_error_paths():
    _, gp = _pair(True, 8, 8)
    for src in (-1, gp.num_nodes):
        with pytest.raises(ValueError, match="out of range"):
            gtt.wtf(gp, src, device="cpu")
    bare = to_device(gp, device="cpu")
    with pytest.raises(ValueError, match="with_csc"):
        topk_device(bare, 10)
    with pytest.raises(ValueError, match="with_csc"):
        gtt.wtf(bare, 0)
    # The JAX package refuses the same.
    with pytest.raises(ValueError, match="out of range"):
        gt.wtf(_pair(True, 8, 8)[0], gp.num_nodes)
