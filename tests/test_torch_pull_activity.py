"""The skip rules of kernels K6 (``pull_min_sweeps``) and K9
(``brandes_fwd_levels`` / ``brandes_bwd_levels``), written here as torch
models and held bit for bit against the port's plain versions, and the
K6 fixpoint against the JAX package's Pallas kernel in interpret mode.

Both gates work on groups of ``group_size(v_pad)`` consecutive source
vertices (4 here, 1024 at 2^20 vertices). K6's rule: a sweep reads only
the edges whose source lies in an active group, one holding a vertex not
+inf at the start of the host call (its first sweep), then one holding a
vertex the previous sweep lowered; every other edge contributes +inf.
K9's rules: the sources outside the groups that hold a gated vertex
contribute 0.0, only the rows that read a total (forward the undiscovered
rows, backward the ring) get one, and a tile of CSC edges that holds no
such row is never read (its edges are poisoned with NaN here, so a read
would show). Both are exact, so the models equal the plain versions
bitwise: distances, labels, sigma, delta and every count. The graphs:
R-MAT scale 8 and 10 with duplicate edges, self loops and zero weights,
and the 64 x 64 grid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gunrock_tpu.ops import pull2 as jpull2
from gunrock_tpu_torch.ops import pull2 as P
from gunrock_tpu_torch.ops.segment import row_reduce_sorted
from test_torch_pr import _pair

INF = float("inf")


def _coo(name):
    """(v_pad, src, dst, weights) of an undirected edge list: both
    directions listed, duplicates and self loops kept, a tenth of the
    weights zero. 4096 vertices (the JAX pull-v2 layout's least), those
    past an R-MAT graph's isolated."""
    rng = np.random.default_rng(len(name))
    if name == "grid64":
        n = 64
        idx = np.arange(n * n).reshape(n, n)
        src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
        dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    else:
        _, src, dst = gtt.io.rmat_coo(int(name[4:]), 8, seed=3)
    v = 4096
    w = rng.uniform(0.0, 16.0, src.shape[0]).astype(np.float32)
    w[rng.random(src.shape[0]) < 0.1] = 0.0
    # R-MAT repeats edges
    assert name == "grid64" or np.unique(src * v + dst).size < src.size
    return (v, np.concatenate([src, dst]), np.concatenate([dst, src]),
            np.concatenate([w, w]))


_GRAPHS = {}


def _graphs(name):
    """The edge list as a JAX pull-v2 graph and a port graph on the CPU."""
    if name not in _GRAPHS:
        v, src, dst, w = _coo(name)
        _GRAPHS[name] = _pair(src, dst, w, v)
    return _GRAPHS[name]


def _f(x, w, wmode):
    if wmode == "add":
        return x + w
    return x + 1.0 if wmode == "incr" else x


def group_active(g, flags):
    """Per vertex: whether its source group holds a vertex in ``flags``."""
    group = torch.arange(g.v_pad) // P.group_size(g.v_pad)
    hit = torch.zeros(int(group[-1]) + 1, dtype=torch.bool)
    hit[group[flags]] = True
    return hit[group]


def k6_model(g, init, *, sweeps, wmode):
    """K6's skip rule in torch: (dist, changed, active edges a sweep)."""
    e = g.num_edges
    src = g.csc_indices[:e].long()
    w = g.csc_edge_values[:e]
    d = init.float()
    moved = d != INF
    changed, edges = [], []
    for _ in range(sweeps):
        on = group_active(g, moved)[src]
        x = torch.where(on, _f(d[src], w, wmode), INF)
        fresh = torch.minimum(d, row_reduce_sorted(x, g.csc_offsets,
                                                   op="min"))
        moved = fresh < d
        changed.append(int(moved.sum()))
        edges.append(int(on.sum()))
        d = fresh
    return d, torch.tensor(changed, dtype=torch.int32), edges


def _seed(g, wmode):
    init = torch.full((g.v_pad,), INF)
    if wmode == "none":         # CC's labels from every fifth vertex
        init[::5] = torch.arange(0, g.v_pad, 5, dtype=torch.float32)
    else:
        init[0] = 0.0
    return init


@pytest.mark.parametrize("wmode", ["add", "incr", "none"])
@pytest.mark.parametrize("name", ["rmat8", "rmat10", "grid64"])
def test_k6_skip_rule_equals_plain_over_continuation_calls(name, wmode):
    """Calls of 3 sweeps to the fixpoint, each call reseeding the active
    set by finiteness: distances and counts equal the plain version's,
    while the rule reads fewer edges than E a sweep."""
    _, g = _graphs(name)
    d = _seed(g, wmode)
    read = total = 0
    for _ in range(200):
        got, chg, edges = k6_model(g, d, sweeps=3, wmode=wmode)
        want, wchg = P.pull_min_sweeps_plain(g, d, sweeps=3, wmode=wmode)
        assert torch.equal(got, want) and torch.equal(chg, wchg)
        read, total = read + sum(edges), total + 3 * g.num_edges
        d = got
        if 0 in chg.tolist():
            break
    else:
        pytest.fail("no fixpoint")
    assert read < total


@pytest.mark.parametrize("wmode", ["add", "incr", "none"])
def test_k6_fixpoint_equals_pallas(wmode):
    """The fixpoint the skip rule reaches equals the JAX package's
    (Gauss-Seidel, its groups skipped by its own activity flags), run in
    interpret mode as tests/test_torch_sssp.py runs it."""
    jg, g = _graphs("rmat10")
    init = _seed(g, wmode)
    want, wchg = jpull2.pull_min_sweeps(jg, jnp.asarray(init.numpy()),
                                        sweeps=24, wmode=wmode,
                                        interpret=True)
    assert 0 in np.asarray(wchg)[0::2]
    got, chg, _ = k6_model(g, init, sweeps=24, wmode=wmode)
    assert 0 in chg.tolist()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tile_live(g, rows):
    """Per CSC edge: whether its tile (PULL_TILE edges) holds an edge of
    one of ``rows``, as K9's gate marks the tiles."""
    e = g.num_edges
    deg = (g.csc_offsets[1:] - g.csc_offsets[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(g.v_pad), deg)
    tile = torch.arange(e) // P.PULL_TILE
    live = torch.zeros(int(tile.max()) + 1 if e else 0, dtype=torch.bool)
    live[tile[rows[dst]]] = True
    return live[tile]


def _k9_pull(g, gated, rows):
    """A level's totals under K9's rules: sources outside the gated
    groups give 0.0, edges of dead tiles NaN, rows outside ``rows``
    NaN."""
    e = g.num_edges
    src = g.csc_indices[:e].long()
    x = torch.where(group_active(g, gated != 0)[src], gated[src], 0.0)
    x = torch.where(_tile_live(g, rows), x, float("nan"))
    acc = row_reduce_sorted(x, g.csc_offsets, op="sum")
    return torch.where(rows, acc, float("nan"))


def k9_fwd_model(g, lab, sig, *, d0, levels):
    counts = []
    for d in range(d0, d0 + levels):
        open_ = lab == INF
        acc = _k9_pull(g, torch.where(lab == float(d - 1), sig, 0.0), open_)
        sig = torch.where(open_, sig + acc, sig)
        new = open_ & (sig > 0)
        lab = torch.where(new, float(d), lab)
        counts.append(int(new.sum()))
    return lab, sig, torch.tensor(counts, dtype=torch.int32)


def k9_bwd_model(g, lab, sig, delta, *, t0, levels):
    counts = []
    for t in range(t0, t0 - levels, -1):
        ring = lab == float(t)
        gated = torch.where(lab == float(t + 1),
                            (1.0 + delta) / sig.clamp(min=1e-30), 0.0)
        delta = torch.where(ring, sig * (delta + _k9_pull(g, gated, ring)),
                            delta)
        counts.append(int(ring.sum()))
    return delta, torch.tensor(counts, dtype=torch.int32)


@pytest.mark.parametrize("name", ["rmat8", "rmat10", "grid64"])
def test_k9_skip_rules_equal_plain(name):
    """One whole source in calls of 4 levels, past the depth included:
    labels, sigma, delta and counts bit for bit, and no poisoned total
    read."""
    _, g = _graphs(name)
    lab = torch.full((g.v_pad,), INF)
    lab[0] = 0.0
    sig = torch.zeros(g.v_pad)
    sig[0] = 1.0
    d, depth = 1, None
    while depth is None:
        got = k9_fwd_model(g, lab, sig, d0=d, levels=4)
        want = P.brandes_fwd_levels_plain(g, lab, sig, d0=d, levels=4)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        lab, sig, chg = got
        if 0 in chg.tolist():
            depth = d + chg.tolist().index(0) - 1
        d += 4
    assert not torch.isnan(sig).any() and depth > 2
    delta = torch.zeros(g.v_pad)
    for t in range(depth + 2, -1, -4):
        n = min(4, t + 1)
        got = k9_bwd_model(g, lab, sig, delta, t0=t, levels=n)
        want = P.brandes_bwd_levels_plain(g, lab, sig, delta, t0=t, levels=n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        delta = got[0]
    assert not torch.isnan(delta).any() and delta.sum() > 0
