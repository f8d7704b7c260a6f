"""The plain BFS reference: against a NumPy search, against the program
on the CPU, its judge, and its controls, which must fail."""

import collections

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gbench.harness import Bench
from conftest import ROOT

BENCH = Bench(ROOT)
BFS = BENCH.plugin("reference", "bfs")
CPU = torch.device("cpu")


def _graphs():
    kron = BENCH.plugin("graphs", "kronecker").generate(
        {"scale": 10, "edge_factor": 8, "initiator": [0.57, 0.19, 0.19,
                                                       0.05]}, 11, CPU)
    rgg = BENCH.plugin("graphs", "rgg").generate(
        {"scale": 10, "radius_factor": 0.55}, 12, CPU)
    return {"kron": kron, "rgg": rgg}


GRAPHS = _graphs()


def _numpy_bfs(n, src, dst, root):
    adj = collections.defaultdict(set)
    for u, v in zip(src.tolist(), dst.tolist()):
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    labels = np.full(n, -1)
    labels[root] = 0
    q = collections.deque([root])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if labels[v] < 0:
                labels[v] = labels[u] + 1
                q.append(v)
    return labels


def _ref(g):
    return BFS.Reference(g["num_nodes"], g["src"], g["dst"],
                         undirected=True, device=CPU)


def _roots(g, k=5):
    deg = np.bincount(g["src"], minlength=g["num_nodes"]) + np.bincount(
        g["dst"], minlength=g["num_nodes"])
    return np.flatnonzero(deg > 0)[:: max(1, g["num_nodes"] // (3 * k))][:k]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_search_equals_numpy_bfs(name):
    g = GRAPHS[name]
    ref = _ref(g)
    for root in _roots(g):
        want = _numpy_bfs(g["num_nodes"], g["src"], g["dst"], int(root))
        np.testing.assert_array_equal(ref.search(int(root)).numpy(), want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_components_and_work(name):
    g = GRAPHS[name]
    ref = _ref(g)
    comp = ref.components().numpy()
    deg = ref.degrees().numpy()
    roots = _roots(g)
    work = ref.work("component_out_degree_sum", roots)
    for root, w in zip(roots, work):
        reached = _numpy_bfs(g["num_nodes"], g["src"], g["dst"],
                             int(root)) >= 0
        np.testing.assert_array_equal(comp == comp[root], reached)
        assert w == deg[reached].sum()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_program_on_cpu_passes_the_judge(name):
    g = GRAPHS[name]
    ref = _ref(g)
    host = gtt.from_coo(g["num_nodes"], g["src"], g["dst"], undirected=True)
    dg = gtt.to_device(host, with_csc=True, with_blocked_csc=True,
                       device="cpu")
    for root in _roots(g):
        r = gtt.bfs(dg, int(root), mark_preds=True, direction_optimized=True)
        got = ref.judge(int(root), {"labels": r.labels, "preds": r.preds})
        assert got == {"label_mismatch": 0, "bad_pred": 0}
        # Its own edge count agrees with the reference's work rule.
        assert r.info["edges_visited"] == ref.work(
            "component_out_degree_sum", [root])[0]
    assert ref.num_edges == host.num_edges


def test_judge_counts_each_fault():
    g = GRAPHS["kron"]
    ref = _ref(g)
    root = int(_roots(g)[0])
    labels = ref.search(root)
    good = {"labels": labels.numpy(), "preds": ref.tree(labels).numpy()}
    assert ref.judge(root, good) == {"label_mismatch": 0, "bad_pred": 0}
    far = int(torch.argmax(labels))
    bad_label = dict(good, labels=good["labels"].copy())
    bad_label["labels"][far] += 1
    assert ref.judge(root, bad_label)["label_mismatch"] == 1
    # A predecessor one level up but not a neighbour, and one at the
    # wrong level (the root, or the vertex itself).
    lab, v = good["labels"], far
    nbrs = set(ref.col[ref.rowptr[v]:ref.rowptr[v + 1]].tolist())
    up = [u for u in np.flatnonzero(lab == lab[v] - 1) if u not in nbrs]
    assert up, "every vertex one level up is a neighbour"
    for u in (up[0], root if lab[v] > 1 else v):
        preds = good["preds"].copy()
        preds[v] = u
        assert ref.judge(root, dict(good, preds=preds))["bad_pred"] == 1
    unreached = np.flatnonzero(lab < 0)
    if unreached.size:
        preds = good["preds"].copy()
        preds[unreached[0]] = root
        assert ref.judge(root, dict(good, preds=preds))["bad_pred"] == 1
    assert ref.judge(root, {"labels": lab[:-1], "preds": None}) == {
        "label_mismatch": g["num_nodes"], "bad_pred": g["num_nodes"]}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("variant", ["no_tree", "one_level_short"])
def test_controls_fail(name, variant):
    """The control, the reference in the program's place with one
    guarantee broken, is judged not correct on every root."""
    g = GRAPHS[name]
    ref = _ref(g)
    for root in _roots(g):
        counts = ref.judge(int(root), ref.control(int(root), variant))
        key = "bad_pred" if variant == "no_tree" else "label_mismatch"
        assert counts[key] > 0, (root, counts)
