"""The benchmark's graph generators against NumPy checks."""

import numpy as np
import pytest
import torch

from gbench.harness import Bench
from conftest import ROOT

BENCH = Bench(ROOT)
KRON = BENCH.plugin("graphs", "kronecker")
RGG = BENCH.plugin("graphs", "rgg")
INIT = (0.57, 0.19, 0.19, 0.05)


def _kron_shares(scale, edges, device, seed=3):
    """Share of (source bit, target bit) = (0,0), (0,1), (1,0), (1,1)
    over every level of unpermuted edges: A, B, C, D in expectation."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s, d = KRON.kronecker_edges(scale, edges, INIT, gen, device)
    s, d = s.cpu().numpy(), d.cpu().numpy()
    counts = np.zeros(4)
    for level in range(scale):
        counts += np.bincount(2 * ((s >> level) & 1) + ((d >> level) & 1),
                              minlength=4)
    return counts / counts.sum()


def test_kronecker_quadrant_shares():
    shares = _kron_shares(10, 16 << 10, torch.device("cpu"))
    np.testing.assert_allclose(shares, INIT, atol=0.005)


@pytest.mark.cuda
def test_kronecker_quadrant_shares_on_card(cuda):
    np.testing.assert_allclose(_kron_shares(16, 16 << 16, cuda), INIT,
                               atol=0.002)


def test_kronecker_graph_is_seeded_and_permuted():
    cfg = {"scale": 9, "edge_factor": 16, "initiator": list(INIT)}
    cpu = torch.device("cpu")
    a = KRON.generate(cfg, 2**31 + 7, cpu)
    b = KRON.generate(cfg, 2**31 + 7, cpu)
    c = KRON.generate(cfg, 2**31 + 8, cpu)
    gen = torch.Generator(device=cpu)
    gen.manual_seed(2**31 + 7)
    plain = dict(zip(("src", "dst"), (
        e.numpy() for e in KRON.kronecker_edges(9, 16 * 512, INIT, gen,
                                                cpu))))
    assert a["num_nodes"] == 512 and a["src"].size == 16 * 512
    assert a["src"].dtype == np.int32
    np.testing.assert_array_equal(a["src"], b["src"])
    assert not np.array_equal(a["src"], c["src"])
    # A permutation of the vertices: the same degree sequence.
    deg = lambda g: np.sort(np.bincount(g["src"], minlength=512)
                            + np.bincount(g["dst"], minlength=512))
    np.testing.assert_array_equal(deg(a), deg(plain))
    assert not np.array_equal(a["src"], plain["src"])


def _rgg_check(n_log, device, seed):
    cfg = {"scale": n_log, "radius_factor": 0.55}
    n, r = 1 << n_log, RGG.radius(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pts = torch.rand(n, 2, generator=gen, device=device, dtype=torch.float64)
    pts, src, dst = RGG.rgg_edges(pts, r)
    g = {"src": src.cpu().numpy(), "dst": dst.cpu().numpy()}
    # generate() gives the same pairs from the same seed.
    made = RGG.generate(cfg, seed, device)
    np.testing.assert_array_equal(made["src"], g["src"])
    np.testing.assert_array_equal(made["dst"], g["dst"])
    xy = pts.cpu().numpy()
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    iu, ju = np.nonzero(np.triu(d2 < r * r, 1))
    want = set(zip(iu.tolist(), ju.tolist()))
    got = list(zip(np.minimum(g["src"], g["dst"]).tolist(),
                   np.maximum(g["src"], g["dst"]).tolist()))
    assert len(got) == len(set(got)), "a pair listed twice"
    assert set(got) == want
    # Vertices numbered in cell order.
    k = int(np.floor(1 / r))
    cell = (np.minimum((xy[:, 0] * k).astype(int), k - 1) * k
            + np.minimum((xy[:, 1] * k).astype(int), k - 1))
    assert np.all(np.diff(cell) >= 0)
    return n, len(got)


def test_rgg_radius_rule():
    n, m = _rgg_check(10, torch.device("cpu"), 2**31 + 3)
    # About n * pi * 0.55^2 * ln(n) / 2 pairs, fewer at the border.
    assert 0.6 * n * np.pi * 0.3025 * np.log(n) / 2 < m \
        < 1.1 * n * np.pi * 0.3025 * np.log(n) / 2


@pytest.mark.cuda
def test_rgg_radius_rule_on_card(cuda):
    _rgg_check(12, cuda, 2**31 + 4)


def test_sample_compares_every_root_served_once():
    """One answer for each distinct root served, up to ``roots`` of
    them drawn from the seed, and the longest query's besides."""
    from gbench import traffic
    s = traffic.Sample(roots=64, seed=2**31 + 5)
    for i in range(200):   # 40 roots, each served 5 times
        s.offer(wall=float(i == 17), root=i % 40, item=(i % 40, i))
    items = s.items()
    assert {r for r, _ in items} == set(range(40))
    assert (17, 17) in items and len(items) in (40, 41)
    assert len({i for _, i in items}) == len(items), "each answer once"
    few = traffic.Sample(roots=8, seed=2**31 + 5)
    for i in range(200):
        few.offer(wall=float(i == 3), root=i % 40, item=(i % 40, i))
    items = few.items()
    assert len({r for r, _ in items[:8]}) == 8 and (3, 3) in items[-1:] + \
        items[:8]
    again = traffic.Sample(roots=8, seed=2**31 + 5)
    for i in range(200):
        again.offer(wall=float(i == 3), root=i % 40, item=(i % 40, i))
    assert again.items() == items


def test_roots_are_uniform_among_vertices_of_nonzero_degree():
    from gbench import traffic
    n = 1000
    src = np.arange(0, 600, dtype=np.int32)
    dst = (src + 1).astype(np.int32)
    dst[::7] = src[::7]   # self-loops leave some vertices of degree 0
    graph = {"num_nodes": n, "src": src, "dst": dst}
    roots = traffic.draw_roots({"rule": "nonzero_degree", "count": 64},
                               graph, True, 2**31 + 3)
    deg = traffic.degrees(n, src, dst, True)
    assert len(set(roots.tolist())) == 64 and np.all(deg[roots] > 0)
    np.testing.assert_array_equal(
        roots, traffic.draw_roots({"rule": "nonzero_degree", "count": 64},
                                  graph, True, 2**31 + 3))


def test_drop_isolated_keeps_the_edges_relabelled():
    """With ``drop_isolated`` no vertex of degree 0 is left (self-loops
    not counted), and the edges between the others are the same set,
    renumbered in id order."""
    cfg = {"scale": 10, "edge_factor": 2, "initiator": list(INIT)}
    cpu = torch.device("cpu")
    full = KRON.generate(cfg, 2**31 + 7, cpu)
    cut = KRON.generate(dict(cfg, drop_isolated=True), 2**31 + 7, cpu)
    n = full["num_nodes"]
    loop = full["src"] == full["dst"]
    has = np.zeros(n, bool)
    has[full["src"][~loop]] = has[full["dst"][~loop]] = True
    assert 0 < cut["num_nodes"] == has.sum() < n
    assert cut["src"].dtype == np.int32
    cut_loop = cut["src"] == cut["dst"]
    deg = (np.bincount(cut["src"][~cut_loop], minlength=cut["num_nodes"])
           + np.bincount(cut["dst"][~cut_loop], minlength=cut["num_nodes"]))
    assert deg.min() > 0
    old = np.flatnonzero(has)   # new id -> old id, in id order
    edges = lambda s, d: sorted(zip(s.tolist(), d.tolist()))
    keep = has[full["src"]]
    assert edges(old[cut["src"]], old[cut["dst"]]) == edges(
        full["src"][keep], full["dst"][keep])
    # Only the self-loops of dropped vertices went.
    assert np.all(loop[~keep])


def test_edge_values_come_from_their_own_stream():
    from gbench import traffic
    rule = {"rule": "uniform", "lo": 0.5, "hi": 2.0}
    cpu = torch.device("cpu")
    a = traffic.edge_values(rule, 5000, 2**31 + 3, cpu)
    assert a.dtype == np.float32 and a.shape == (5000,)
    assert 0.5 <= a.min() and a.max() < 2.0 and a.std() > 0.3
    np.testing.assert_array_equal(
        a, traffic.edge_values(rule, 5000, 2**31 + 3, cpu))
    assert not np.array_equal(
        a, traffic.edge_values(rule, 5000, 2**31 + 4, cpu))
    assert traffic.VALUES not in (traffic.ROOTS, traffic.CHECK)
    with pytest.raises(ValueError):
        traffic.edge_values({"rule": "normal"}, 10, 1, cpu)


def test_draw_compares_answers_of_a_whole_graph_mix():
    """``answers`` of the offered answers, drawn from the seed, and the
    longest query's besides; the same seed draws the same."""
    from gbench import traffic

    def draw(seed, offered=300, longest=123):
        d = traffic.Sample(roots=1, seed=seed, answers=2)
        for i in range(offered):
            d.offer(wall=float(i == longest), root=None, item=i)
        return d.items()

    items = draw(2**31 + 5)
    assert len(items) == 3 and items[-1] == 123 and len(set(items)) == 3
    assert draw(2**31 + 5) == items
    assert any(draw(s)[:2] != items[:2] for s in range(6))
    # Every answer is drawn alike: the first and the last half of the
    # window are both drawn.
    firsts = [min(draw(s, longest=299)[:2]) < 150 for s in range(200)]
    assert 0.5 < sum(firsts) / 200 < 0.9
    assert draw(1, offered=1, longest=0) == [0]
