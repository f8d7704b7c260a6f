"""The plain PageRank reference: against a NumPy power iteration,
against the program on the CPU, its judge, and its controls, which must
fail."""

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gbench import harness
from conftest import ROOT

BENCH = harness.Bench(ROOT)
PR = BENCH.plugin("reference", "pagerank")
KRON = BENCH.plugin("graphs", "kronecker")
CPU = torch.device("cpu")
CFG = BENCH.config("graphalytics-graph500-22")
ALGO = CFG["algorithm"]
ENTRY = BENCH.traffic("closed_pr_graphalytics")["entry"]["kwargs"]


def _graph(scale, seed, **cfg):
    return KRON.generate(dict(CFG, scale=scale, **cfg), seed, CPU)


def _directed(n=300, m=900, seed=4):
    """A directed graph with vertices of no out-edge (dangling) and
    duplicate edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n // 2, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    return {"num_nodes": n, "src": src, "dst": dst}


GRAPHS = {"kron_dropped": (_graph(10, 11), True),
          "kron_isolated": (_graph(10, 12, edge_factor=1,
                                   drop_isolated=False), True),
          "directed": (_directed(), False)}


def _ref(name):
    g, undirected = GRAPHS[name]
    return PR.Reference(g["num_nodes"], g["src"], g["dst"],
                        undirected=undirected, device=CPU, **ALGO)


def _numpy_pagerank(g, undirected, damping, iterations):
    n = g["num_nodes"]
    a = np.zeros((n, n))
    s, d = g["src"].astype(int), g["dst"].astype(int)
    a[s, d] = 1.0
    if undirected:
        a[d, s] = 1.0
    np.fill_diagonal(a, 0.0)
    deg = a.sum(1)
    rank = np.full(n, 1.0 / n)
    for _ in range(iterations):
        share = np.where(deg > 0, rank / np.maximum(deg, 1), 0.0)
        rank = ((1 - damping) / n + damping * (share @ a)
                + damping * rank[deg == 0].sum() / n)
    return rank


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ranks_equal_numpy_power_iteration(name):
    g, undirected = GRAPHS[name]
    ref = _ref(name)
    want = _numpy_pagerank(g, undirected, ALGO["damping"],
                           ALGO["iterations"])
    np.testing.assert_allclose(ref.ranks().numpy(), want, rtol=1e-12)
    assert ref.ranks().sum().item() == pytest.approx(1.0, abs=1e-12)
    if name != "kron_dropped":
        assert (ref.deg == 0).any(), "no dangling vertex to test"


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_program_on_cpu_passes_the_judge(name):
    g, undirected = GRAPHS[name]
    ref = _ref(name)
    host = gtt.from_coo(g["num_nodes"], g["src"], g["dst"],
                        undirected=undirected)
    dg = gtt.to_device(host, with_csc=True, device="cpu")
    r = gtt.pagerank(dg, **ENTRY)
    got = ref.judge(None, {"ranks": r.ranks, "node_ids": r.node_ids})
    assert got["rank_off"] == 0 and got["bad_order"] == 0
    assert got["rank_rel_err"] < PR.RTOL
    # Its own edge count agrees with the reference's work rule, where it
    # runs every iteration (it stops early at a fixed point in float32,
    # as the small directed graph reaches one).
    assert ref.num_edges == host.num_edges
    iters = r.info["search_depth"]
    assert r.info["edges_visited"] == ref.num_edges * iters
    assert iters == ALGO["iterations"] or name == "directed"
    if iters == ALGO["iterations"]:
        assert [r.info["edges_visited"]] == ref.work(
            "edges_times_iterations", [None])


def test_judge_counts_each_fault():
    ref = _ref("kron_dropped")
    n = ref.n
    rank = ref.ranks().float()
    ids = torch.sort(-rank, stable=True).indices.to(torch.int32).numpy()
    good = {"ranks": rank.numpy(), "node_ids": ids}
    got = ref.judge(None, good)
    assert got["rank_off"] == 0 and got["bad_order"] == 0
    off = dict(good, ranks=good["ranks"].copy())
    off["ranks"][ids[-1]] *= 1.0 + 3 * PR.RTOL   # the lowest, still lowest
    got = ref.judge(None, off)
    assert got["rank_off"] == 1 and got["bad_order"] == 0
    assert got["rank_rel_err"] == pytest.approx(3 * PR.RTOL, rel=1e-3)
    nan = dict(good, ranks=good["ranks"].copy())
    nan["ranks"][5] = np.nan
    assert ref.judge(None, nan)["rank_rel_err"] == float("inf")
    assert ref.judge(None, nan)["rank_off"] == 1
    # Two neighbours in the order swapped: one pair out of order (and a
    # tie the wrong way round reads so too).
    swapped = ids.copy()
    swapped[[0, 1]] = swapped[[1, 0]]
    assert ref.judge(None, dict(good, node_ids=swapped))["bad_order"] == 1
    tie = {"ranks": np.full(n, 1.0 / n, np.float32),
           "node_ids": np.arange(n, dtype=np.int32)[::-1].copy()}
    assert ref.judge(None, tie)["bad_order"] == n - 1
    # An id twice (and so one missing), an id out of range.
    twice = ids.copy()
    twice[-1] = twice[0]
    assert ref.judge(None, dict(good, node_ids=twice))["bad_order"] >= 2
    out = ids.copy()
    out[-1] = n
    assert ref.judge(None, dict(good, node_ids=out))["bad_order"] >= 2
    assert ref.judge(None, {"ranks": good["ranks"][:-1], "node_ids": None}) \
        == {"rank_off": n, "bad_order": n, "rank_rel_err": float("inf")}
    with pytest.raises(ValueError):
        ref.judge(3, good)


@pytest.mark.parametrize("variant", PR.CONTROLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 9, 2**32 + 21])
def test_controls_fail(variant, seed):
    """The control, the reference in the program's place with one
    guarantee broken, is judged not correct, on the configuration's
    graph at scale 11 and edge factor 1. The ranks that settle last sit
    in the small components of the Kronecker graph's fringe, which scale
    22 has by the thousand (one iteration short reads a relative error
    of 0.14 there); at 2**11 vertices an edge factor of 16 leaves
    almost none, and 1 gives them back."""
    g = _graph(11, seed, edge_factor=1)
    ref = PR.Reference(g["num_nodes"], g["src"], g["dst"], undirected=True,
                       device=CPU, **ALGO)
    counts = ref.judge(None, ref.control(None, variant))
    assert counts["rank_off"] > 0 and counts["bad_order"] == 0, counts
    assert counts["rank_rel_err"] > PR.RTOL
