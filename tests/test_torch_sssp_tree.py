"""The SSSP predecessors form a shortest-path tree rooted at the source,
also where weights of 0, or weights below half an ulp of the distance
they are added to, make neighbours equally far: on small graphs with such
weights planted, where the JAX package's fill (the last in-neighbour in
CSC order with ``dist[u] + w == dist[v]``, -1 at distance 0) leaves a
vertex without a parent or points two vertices at each other, and on
random graphs with many zero weights, over the push loop, near-far and
the sweep route. Distances are exact: the fill does not touch them."""

import importlib

import numpy as np
import pytest

import gunrock_tpu_torch as gtt

# models/__init__ rebinds "sssp" to the function
msssp = importlib.import_module("gunrock_tpu_torch.models.sssp")


def _csc(dg):
    n, e = dg.num_nodes, dg.num_edges
    off = dg.csc_offsets.numpy().astype(np.int64)[:n + 1]
    src = dg.csc_indices.numpy()[:e].astype(np.int64)
    dst = np.repeat(np.arange(n), np.diff(off))
    return src, dst, dg.csc_edge_values.numpy()[:e]


def _bellman_ford(dg, root):
    """float32 distances over the uploaded graph's edges: relax every
    edge until nothing changes."""
    n = dg.num_nodes
    s, d, w = _csc(dg)
    dist = np.full(n, np.inf, np.float32)
    dist[root] = 0.0
    while True:
        new = dist.copy()
        np.minimum.at(new, d, (dist[s] + w).astype(np.float32))
        if np.array_equal(new, dist):
            return dist
        dist = new


def _jax_rule_fill(dg, dist):
    """The JAX package's fill rule, over the port's CSC."""
    s, d, w = _csc(dg)
    hit = (dist[s] + w).astype(np.float32) == dist[d]
    preds = np.full(dg.num_nodes, -1, np.int64)
    for u, v in zip(s[hit], d[hit]):     # CSC order: the last hit stays
        preds[v] = u
    preds[~(np.isfinite(dist) & (dist > 0))] = -1
    return preds


def _tree_faults(dg, dist, preds, root):
    """(bad links, reached vertices whose chain misses the root): a
    link is bad unless it is an in-edge u -> v with dist[u] + w ==
    dist[v] (the root's pred -1 or itself, an unreached vertex's -1)."""
    s, d, w = _csc(dg)
    tight = {(int(u), int(v)) for u, v, x in zip(s, d, w)
             if np.float32(dist[u] + x) == dist[v]}
    reached = np.isfinite(dist)
    bad = int(preds[root] not in (-1, root))
    bad += int((preds[~reached] != -1).sum())
    bad += sum((int(preds[v]), v) not in tight
               for v in np.flatnonzero(reached) if v != root)
    cut = 0
    for v in np.flatnonzero(reached):
        seen, x = set(), v
        while x != root and x >= 0 and x not in seen:
            seen.add(x)
            x = preds[x]
        cut += x != root
    return bad, cut


def _upload(n, s, d, w, **flags):
    g = gtt.from_coo(n, np.asarray(s), np.asarray(d),
                     values=np.asarray(w, np.float32), undirected=True)
    return gtt.to_device(g, with_edge_values=True, with_csc=True,
                         device="cpu", **flags)


# (name, edges (u, v, w), root, what the JAX package's rule leaves).
PLANTED = {
    # A weight-0 edge from the root: vertex 1 lies at distance 0.
    "zero_from_root": ([(0, 1, 0.0), (1, 2, 0.5), (0, 3, 0.75)], 0,
                       "missing"),
    # 3 and 4 equally far through a weight-0 edge; each one's nearer
    # parent has the smaller id, so the last hit of each is the other.
    "zero_tie": ([(0, 1, 1.0), (0, 2, 1.0), (1, 3, 0.5), (2, 4, 0.5),
                  (3, 4, 0.0)], 0, "cycle"),
    # The same with a weight the float32 add absorbs: 1.5 + 1e-9.
    "absorbed_tie": ([(0, 1, 1.0), (0, 2, 1.0), (1, 3, 0.5), (2, 4, 0.5),
                      (3, 4, 1e-9)], 0, "cycle"),
    # A chain of weight-0 edges: 2, 3 and 4 have only equally far hits
    # and settle in three rounds, each on one settled before it.
    "zero_chain": ([(0, 1, 0.25), (1, 2, 0.0), (2, 3, 0.0), (3, 4, 0.0),
                    (0, 5, 0.75)], 0, "cycle"),
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_planted_ties_give_a_tree(name):
    edges, root, fault = PLANTED[name]
    s, d, w = (np.array(c) for c in zip(*edges))
    n = int(max(s.max(), d.max())) + 1
    dg = _upload(n, s, d, w)
    res = gtt.sssp(dg, root, mark_preds=True, device="cpu")
    want = _bellman_ford(dg, root)
    np.testing.assert_array_equal(res.distances, want)
    assert _tree_faults(dg, res.distances, res.preds, root) == (0, 0)
    old = _jax_rule_fill(dg, res.distances)
    bad, cut = _tree_faults(dg, res.distances, old, root)
    if fault == "missing":
        assert bad >= 1 and (old[1], res.preds[1]) == (-1, root)
    else:
        assert cut >= 2
        v = np.flatnonzero((old >= 0) & (old[np.maximum(old, 0)] ==
                                         np.arange(n)))
        assert v.size >= 2, "the JAX rule closes no 2-cycle here"


def _random_zero_weights(seed, n=2000, m=12000, zeros=0.1):
    rng = np.random.default_rng(seed)
    s, d = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.random(m).astype(np.float32)
    w[rng.random(m) < zeros] = 0.0
    w[rng.random(m) < 0.01] = np.float32(1e-9)
    return n, s, d, w


@pytest.mark.parametrize("mode", ["bellman", "nearfar", "sweeps"])
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_random_zero_weights_give_a_tree(mode, seed, monkeypatch):
    """Every route's preds against the same tree checks, from three
    roots; the sweep route is taken on a graph uploaded
    with_blocked_values whose v_pad passes pull2_ok, and run to its
    fixpoint (no bail-out after 48 sweeps)."""
    monkeypatch.setenv("GUNROCK_SWEEP_BAIL", "100000")
    n, s, d, w = _random_zero_weights(seed, n=5120, m=30000)
    flags = {"with_blocked_values": True} if mode == "sweeps" else {}
    dg = _upload(n, s, d, w, **flags)
    assert dg.has_pull2 == (mode == "sweeps")
    for root in (0, 7, int(np.argmax(np.bincount(s, minlength=n)))):
        res = gtt.sssp(dg, root, mark_preds=True, device="cpu",
                       mode="bellman" if mode == "sweeps" else mode,
                       delta_factor=0.5)
        assert res.info["route"] == ("pull_sweeps" if mode == "sweeps"
                                     else mode)
        want = _bellman_ford(dg, root)
        np.testing.assert_array_equal(res.distances, want)
        assert _tree_faults(dg, res.distances, res.preds, root) == (0, 0)


def test_ties_settle_only_on_settled_vertices(monkeypatch):
    """The tie rounds run where no strictly nearer hit exists, and only
    there: once on a zero-weight chain, never with positive weights."""
    calls = []
    real = msssp._fill_ties

    def spy(graph, dist, preds, ties):
        calls.append(sorted(ties.tolist()))
        return real(graph, dist, preds, ties)
    monkeypatch.setattr(msssp, "_fill_ties", spy)
    edges, root, _ = PLANTED["zero_chain"]
    s, d, w = (np.array(c) for c in zip(*edges))
    res = gtt.sssp(_upload(6, s, d, w), root, mark_preds=True, device="cpu")
    assert calls == [[2, 3, 4]]
    assert res.preds.tolist() == [-1, 0, 1, 2, 3, 0]
    calls.clear()
    n, s, d, w = _random_zero_weights(3, zeros=0.0)
    w = np.maximum(w, np.float32(0.01))
    gtt.sssp(_upload(n, s, d, w), 0, mark_preds=True, device="cpu")
    assert calls == []
