"""The plain SSSP reference: its edges against the program's build,
its Bellman-Ford against a NumPy one, the program on the CPU against
it, its judge, and its controls, which must fail."""

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gbench import harness
from conftest import ROOT

BENCH = harness.Bench(ROOT)
SSSP = BENCH.plugin("reference", "sssp")
KRON = BENCH.plugin("graphs", "kronecker")
CPU = torch.device("cpu")
CFG = BENCH.config("graph500-s22-ef16-k3")
TRAFFIC = BENCH.traffic("closed_sssp")
ENTRY = TRAFFIC["entry"]["kwargs"]
BUILD = TRAFFIC["build"]["kwargs"]


def _kron(scale, seed, **cfg):
    """The configuration's graph and weights at ``scale``."""
    return harness.make_graph(KRON, dict(CFG, scale=scale, **cfg), seed, CPU)


def _planted(n=400, m=2400, seed=4):
    """A directed graph with duplicate edges, weight-0 edges and weights
    a float32 add absorbs."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    src[m // 2:m // 2 + 50], dst[m // 2:m // 2 + 50] = src[:50], dst[:50]
    w = rng.random(m).astype(np.float32)
    w[rng.random(m) < 0.05] = 0.0
    w[rng.random(m) < 0.02] = np.float32(1e-9)
    return {"num_nodes": n, "src": src, "dst": dst, "values": w}


GRAPHS = {"kron": (_kron(10, 11), True), "planted": (_planted(), False),
          "planted_undirected": (_planted(seed=5), True)}


def _ref(g, undirected):
    return SSSP.Reference(g["num_nodes"], g["src"], g["dst"],
                          undirected=undirected, device=CPU,
                          values=g["values"])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_edges_are_those_of_the_programs_build(name):
    """Every copy of an edge kept, as the traffic asks of the program's
    build (``from_coo`` with ``dedup=False``): the same edges with the
    same weights, the least weight first among an edge's copies."""
    assert BUILD == {"dedup": False}
    g, undirected = GRAPHS[name]
    ref = _ref(g, undirected)
    host = gtt.from_coo(g["num_nodes"], g["src"], g["dst"],
                        values=g["values"], undirected=undirected, **BUILD)
    n = g["num_nodes"]
    keys = (np.repeat(np.arange(n), np.diff(host.row_offsets)) * n
            + host.col_indices)
    order = np.lexsort((host.edge_values, keys))
    np.testing.assert_array_equal(ref.keys.numpy(), keys[order])
    np.testing.assert_array_equal(ref.w.numpy(), host.edge_values[order])
    assert ref.num_edges == host.num_edges


def test_the_least_copy_of_an_edge_decides():
    """An edge listed twice, the lighter copy second: the reference and
    the program built as the traffic builds it take the lighter, and an
    answer over the first-listed copy alone is judged wrong."""
    src, dst = np.array([0, 1, 0], np.int32), np.array([1, 2, 1], np.int32)
    w = np.array([0.5, 0.25, 0.125], np.float32)
    ref = SSSP.Reference(3, src, dst, undirected=False, device=CPU, values=w)
    assert ref.distances(0)[0].tolist() == [0.0, 0.125, 0.375]
    want = {"dist_mismatch": 0, "bad_pred": 0, "not_tree": 0}
    for build, ok in ((BUILD, True), ({}, False)):
        host = gtt.from_coo(3, src, dst, values=w, **build)
        dg = gtt.to_device(host, device="cpu", **TRAFFIC["upload"]["kwargs"])
        r = gtt.sssp(dg, 0, device="cpu", **ENTRY)
        got = ref.judge(0, {"distances": r.distances, "preds": r.preds})
        assert ({k: got[k] for k in want} == want) is ok, (build, got)


def _numpy_bellman_ford(ref, root, dtype):
    n = ref.n
    row = np.repeat(np.arange(n), np.diff(ref.rowptr.numpy()))
    col, w = ref.col.numpy(), ref.w.numpy().astype(dtype)
    d = np.full(n, np.inf, dtype)
    d[root] = 0
    while True:
        new = d.copy()
        np.minimum.at(new, col, (d[row] + w).astype(dtype))
        if np.array_equal(new, d):
            return d
        d = new


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_distances_equal_a_numpy_bellman_ford(name):
    g, undirected = GRAPHS[name]
    ref = _ref(g, undirected)
    for root in (0, 3, int(np.argmax(ref.degrees().numpy()))):
        got, _ = ref.distances(root, dtype=torch.float64)
        np.testing.assert_array_equal(
            got.numpy(), _numpy_bellman_ford(ref, root, np.float64))
        got, rounds = ref.distances(root)
        want = _numpy_bellman_ford(ref, root, np.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        # One round fewer leaves distances above the fixpoint.
        if rounds:
            short, _ = ref.distances(root, rounds=rounds - 1)
            assert (short.numpy() >= want).all()
            assert (short.numpy() != want).any()


def _tree_ok(ref, root, d, preds):
    got = ref.judge(root, {"distances": d.numpy(), "preds": preds.numpy()})
    return got["dist_mismatch"], got["bad_pred"], got["not_tree"]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_reference_tree_passes_its_judge(name):
    g, undirected = GRAPHS[name]
    ref = _ref(g, undirected)
    for root in (0, 5):
        d, _ = ref.distances(root)
        assert _tree_ok(ref, root, d, ref.tree(root, d)) == (0, 0, 0)


@pytest.mark.parametrize("scale,seed", [(10, 3), (11, 2**31 + 9),
                                        (12, 2**32 + 21)])
def test_program_on_cpu_passes_the_judge(scale, seed):
    """sssp() on the configuration's graph (weights uniform in [0, 1)),
    uploaded as the traffic uploads it, from the traffic's roots:
    distances bit for bit and a tree."""
    g = _kron(scale, seed)
    ref = _ref(g, True)
    # Six of nonzero degree (at edge factor 16 these scales often have
    # no component beside the largest to draw one from).
    tr = dict(TRAFFIC, roots={"rule": "nonzero_degree", "count": 6})
    roots = harness.draw_roots(SSSP, CFG, tr, g, True, seed, CPU)
    host = gtt.from_coo(g["num_nodes"], g["src"], g["dst"],
                        values=g["values"], undirected=True, **BUILD)
    dg = gtt.to_device(host, device="cpu", **TRAFFIC["upload"]["kwargs"])
    for root in roots:
        r = gtt.sssp(dg, root, device="cpu", **ENTRY)
        got = ref.judge(root, {"distances": r.distances, "preds": r.preds})
        assert (got["dist_mismatch"], got["bad_pred"], got["not_tree"]) == \
            (0, 0, 0), (root, got)
        assert 0 <= got["dist_rel_err"] < 1e-5
        # Its own edge count is the reference's work rule.
        assert [r.info["edges_visited"]] == ref.work(
            "component_out_degree_sum", [root])


def test_judge_counts_each_fault():
    g, undirected = GRAPHS["planted_undirected"]
    ref = _ref(g, undirected)
    n, root = ref.n, 0
    d, _ = ref.distances(root)
    tree = ref.tree(root, d)
    good = {"distances": d.numpy(), "preds": tree.numpy()}
    assert _tree_ok(ref, root, d, tree) == (0, 0, 0)
    far = int(torch.argmax(torch.where(torch.isfinite(d), d, -1.0)))
    # One distance one ulp off.
    off = dict(good, distances=good["distances"].copy())
    off["distances"][far] = np.nextafter(off["distances"][far], np.inf)
    got = ref.judge(root, off)
    assert got["dist_mismatch"] == 1 and got["bad_pred"] == 0
    assert 0 < got["dist_rel_err"] < 1e-6
    # A pred that is no in-edge meeting the equality; the root's own.
    bad = dict(good, preds=good["preds"].copy())
    bad["preds"][far] = root if tree[far] != root else far
    assert ref.judge(root, bad)["bad_pred"] >= 1
    rootp = dict(good, preds=good["preds"].copy())
    rootp["preds"][root] = far
    assert ref.judge(root, rootp)["bad_pred"] == 1
    # An unreached vertex is reached, or a reached one unreached.
    unreached = np.flatnonzero(~np.isfinite(good["distances"]))
    if unreached.size:
        wrong = dict(good, distances=good["distances"].copy())
        wrong["distances"][unreached[0]] = 1.0
        got = ref.judge(root, wrong)
        assert got["dist_mismatch"] == 1 and got["dist_rel_err"] == np.inf
    assert ref.judge(root, {"distances": None, "preds": None}) == {
        "dist_mismatch": n, "bad_pred": n, "not_tree": n,
        "dist_rel_err": np.inf}


def test_a_tie_pointed_both_ways_is_seen_by_the_tree_check_alone():
    """The planted graph has equally far neighbours joined by weight-0
    edges; pointed at each other, each link meets the equality, and
    only the chains fail."""
    g, undirected = GRAPHS["planted_undirected"]
    ref = _ref(g, undirected)
    counts = ref.judge(0, ref.control(0, "swapped_tie"))
    assert counts["dist_mismatch"] == 0 and counts["bad_pred"] == 0
    assert counts["not_tree"] >= 2


@pytest.mark.parametrize("variant", SSSP.CONTROLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 9, 2**32 + 21])
def test_controls_fail(variant, seed):
    """The control, the reference in the program's place with one
    guarantee broken, is judged not correct, on the configuration's
    graph at scale 11."""
    g = _kron(11, seed)
    ref = _ref(g, True)
    root = int(np.argmax(ref.degrees().numpy()))
    counts = ref.judge(root, ref.control(root, variant))
    assert any(counts[k] > lim for k, lim in SSSP.LIMITS.items()), counts
    if variant in ("one_round_short", "bf16_weights"):
        assert counts["dist_mismatch"] > 0
        assert counts["dist_rel_err"] > 1e-5
    else:
        assert counts["dist_mismatch"] == 0 and counts["not_tree"] > 0
