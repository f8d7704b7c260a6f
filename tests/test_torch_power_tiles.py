"""K4 on the CPU: what ``pull_power_iters`` runs on the card
(``csrc/pull_kernels.cu``), modelled in numpy and held against
``ops.pull2.pull_power_iters_plain``, and that plain version against the
JAX package's ``pull_power_iters`` in interpret mode.

A round on the card is K3's pass 1 over tiles of ``PULL_TILE`` CSC edges
(the row of each tile's first edge from ``tile_rows_kernel``, once a
call; the rows that start in a tile from a walk of ``csc_offsets``; 8
edges a thread, reduced in order; a block scan; the run, head and tail
partials) and K4's own finish (each row's total combined in tile order,
the epilogue, the change count, and the next round's ``wpr`` fold, so
that only the first round has a fold pass). The models below follow it
thread by thread.

Tolerances: the tile rows and the row of every edge are exact; a round
through the model sums in float32 in the kernel's per-thread order where
the plain version sums in float64, so it carries rtol 1e-5; the JAX
comparison keeps ``tests/test_torch_pr.py``'s rtol 3e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gunrock_tpu.ops import pull2 as jpull2
from gunrock_tpu_torch.ops import pull2 as P
from test_torch_pr import _pair

TILE = P.PULL_TILE
THREADS, ITEMS = 256, 8           # kThreads, kItems in csrc/pull_kernels.cu


def _coo_graph(n, deg, seed, weights=True):
    """A directed graph whose CSC row v holds deg[v] edges from random
    sources, with edge values for the ``val`` weights."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, dst.shape[0])
    vals = rng.uniform(0.0, 64.0, dst.shape[0]).astype(np.float32)
    g = gtt.from_coo(n, src, dst, vals if weights else None,
                     remove_self_loops=False, dedup=False)
    dg = gtt.to_device(g, with_csc=True, with_edge_values=weights,
                       with_blocked_values=True, device="cpu")
    assert dg.num_edges == int(np.sum(deg))
    return dg


def _tile_graph(residue):
    """tests/test_torch_cuda.py's tile edge-case graph on the CPU: row 2
    starts exactly at the second tile and is a hub of three tiles and
    more; runs of empty rows; ``residue`` edges mod 4, no whole tile."""
    rng = np.random.default_rng(residue)
    n = 4 * TILE
    deg = np.zeros(n, np.int64)
    deg[0], deg[1], deg[2] = TILE - 5, 5, 3 * TILE + 7
    body = rng.integers(0, 4, n - 150) * (rng.random(n - 150) < 0.5)
    deg[100:n - 50] = body
    deg[100] += (residue - deg.sum()) % 4
    dg = _coo_graph(n, deg, residue)
    assert int(dg.csc_offsets[2]) == TILE and dg.num_edges % TILE
    return dg


def _boundary_graph():
    """Empty rows at tile boundaries: rows 0-4 empty before the first
    edge, a row ending exactly at each of the first three tile ends with
    empty rows after it, a row starting at a tile's last edge, and a
    whole last tile."""
    n = 64
    deg = np.zeros(n, np.int64)
    deg[5] = TILE                          # tile 0 exactly
    deg[12] = TILE - 3                     # rows 6-11 empty at the boundary
    deg[13] = 3                            # ends tile 1
    deg[20] = TILE - 1                     # rows 14-19 empty
    deg[21] = 1                            # the last edge of tile 2
    deg[22] = 2 * TILE                     # two whole tiles
    dg = _coo_graph(n, deg, 11)
    assert dg.num_edges == 5 * TILE
    return dg


def _graph(name):
    if name.startswith("rmat"):
        g = gtt.io.rmat(scale=int(name[4:]), edge_factor=16, seed=7,
                        undirected=True)
        g.random_edge_values(seed=7)
        return gtt.to_device(g, with_csc=True, with_edge_values=True,
                             with_blocked_values=True, device="cpu")
    if name.startswith("tile"):
        return _tile_graph(int(name[4:]))
    if name == "boundaries":
        return _boundary_graph()
    if name == "below_tile":
        rng = np.random.default_rng(9)
        return _coo_graph(700, rng.integers(0, 5, 700) * (rng.random(700)
                                                           < 0.6), 9)
    assert name == "no_edges"
    return _coo_graph(300, np.zeros(300, np.int64), 3)


GRAPHS = ["rmat10", "rmat11", "rmat12", "tile1", "tile3", "boundaries",
          "below_tile", "no_edges"]


def tile_rows_model(g) -> np.ndarray:
    """tile_rows_kernel: entry t the row holding edge t * TILE (written by
    that row, so an empty row never holds one), entry ntiles v_pad."""
    offs = g.csc_offsets.numpy().astype(np.int64)
    ntiles = -(-g.num_edges // TILE)
    out = np.full(ntiles + 1, -1, np.int64)
    for v in range(g.v_pad):
        t = -(-offs[v] // TILE)
        while t * TILE < offs[v + 1]:
            out[t] = v
            t += 1
    out[ntiles] = g.v_pad
    return out


def tile_starts(g, tile_rows, t) -> np.ndarray:
    """Pass 1's walk for tile t: entry p the row that starts at the
    tile's edge p, else -1, from the rows tile_rows[t] + 1 ..
    tile_rows[t + 1] alone."""
    offs = g.csc_offsets.numpy().astype(np.int64)
    lo = t * TILE
    length = min(TILE, g.num_edges - lo)
    starts = np.full(TILE, -1, np.int64)
    for r in range(tile_rows[t] + 1, min(tile_rows[t + 1], g.v_pad - 1) + 1):
        if offs[r] < lo + length and offs[r + 1] > offs[r]:
            starts[offs[r] - lo] = r
    return starts


def pass1_model(g, tile_rows, x_all):
    """K3's pass 1 (sum, ungated) in float32, a thread at a time: the
    exclusive scan gives each thread the value and row it continues;
    it closes the runs that end in it into rowval, the tile's first run
    also into head and its last into tail."""
    e = g.num_edges
    ntiles = -(-e // TILE)
    rowval = np.full(g.v_pad, np.nan, np.float32)
    head = np.full(ntiles, np.nan, np.float32)
    tail = np.full(ntiles, np.nan, np.float32)
    zero = np.float32(0.0)
    for t in range(ntiles):
        lo = t * TILE
        length = min(TILE, e - lo)
        first_row = tile_rows[t]
        starts = tile_starts(g, tile_rows, t)

        def emit(row, val, last):
            rowval[row] = val
            if row == first_row:
                head[t] = val
            if last:
                tail[t] = val

        carry, scan_row = zero, -1
        for tid in range(THREADS):
            p0 = tid * ITEMS
            n = max(0, min(ITEMS, length - p0))
            x = x_all[lo + p0:lo + p0 + n]
            st = starts[p0:p0 + n]
            if n > 0:
                row = scan_row if scan_row >= 0 else first_row
                acc = carry if tid > 0 and st[0] < 0 else zero
                for k in range(n):
                    if st[k] >= 0:
                        if k > 0:
                            emit(row, acc, False)
                        row, acc = st[k], zero
                    acc = np.float32(acc + x[k])
                pe = p0 + n
                if pe == length or starts[pe] >= 0:
                    emit(row, acc, pe == length)
            trail, flag = zero, tid == 0
            for k in range(n):
                if st[k] >= 0:
                    trail, flag = zero, True
                    scan_row = max(scan_row, st[k])
                trail = np.float32(trail + x[k])
            carry = trail if flag else np.float32(carry + trail)
    return rowval, head, tail


def finish_model(g, rowval, head, tail, rank, w, *, damping, reset,
                 threshold, fold):
    """K4's finish: each row's total (rowval inside one tile, else tail,
    whole tiles' heads and the last head in tile order), rank' = v <
    num_nodes ? reset + damping * total : 0, the count of |rank' - rank|
    > threshold and, with fold, the next round's rank' * w."""
    offs = g.csc_offsets.numpy().astype(np.int64)
    d32, r32, zero = np.float32(damping), np.float32(reset), np.float32(0)
    out = np.zeros(g.v_pad, np.float32)
    folded = np.zeros(g.v_pad, np.float32) if fold else None
    changed = 0
    for v in range(g.v_pad):
        lo, hi = offs[v], offs[v + 1]
        acc = zero
        if hi > lo:
            c0, c1 = lo // TILE, (hi - 1) // TILE
            if c0 == c1:
                acc = rowval[v]
            else:
                acc = tail[c0]
                for c in range(c0 + 1, c1 + 1):
                    acc = np.float32(acc + head[c])
        fresh = np.float32(r32 + np.float32(d32 * acc)) \
            if v < g.num_nodes else zero
        changed += int(abs(np.float32(fresh - rank[v])) > threshold)
        out[v] = fresh
        if fold:
            folded[v] = np.float32(fresh * w[v])
    assert np.isfinite(out).all()
    return out, folded, changed


def k4_model(g, init, *, iters, weights, damping, reset, threshold):
    """pull_power_iters as the card runs it: the tile rows once, the wpr
    fold once, then rounds of pass 1 and the finish, each finish but the
    last folding the next round's values."""
    e = g.num_edges
    src = g.csc_indices[:e].numpy().astype(np.int64)
    tile_rows = tile_rows_model(g)
    rank = init.numpy().astype(np.float32)
    per_source = weights == "wpr"
    w = (g.inv_outdeg if per_source else g.csc_edge_values).numpy()
    folded = (rank * w).astype(np.float32) if per_source else None
    changed = []
    for r in range(iters):
        x_all = folded[src] if per_source else \
            (rank[src] * w[:e]).astype(np.float32)
        rowval, head, tail = pass1_model(g, tile_rows, x_all)
        rank, folded, c = finish_model(
            g, rowval, head, tail, rank, w, damping=damping, reset=reset,
            threshold=threshold, fold=per_source and r + 1 < iters)
        changed.append(c)
    return torch.from_numpy(rank), changed


@pytest.mark.parametrize("name", GRAPHS)
def test_tile_rows_rebuild_each_edge_row(name):
    """From tile_rows and each tile's walk of csc_offsets, carrying each
    start forward over the tile, every edge's row is exactly
    repeat_interleave of csc_offsets; tile_rows never names an empty
    row."""
    g = _graph(name)
    offsets = g.csc_offsets
    deg = offsets[1:] - offsets[:-1]
    want = torch.repeat_interleave(torch.arange(g.v_pad), deg.long(),
                                   output_size=g.num_edges).numpy()
    tile_rows = tile_rows_model(g)
    ntiles = tile_rows.shape[0] - 1
    assert tile_rows[ntiles] == g.v_pad
    assert (deg.numpy()[tile_rows[:ntiles]] > 0).all()
    got = np.empty(g.num_edges, np.int64)
    for t in range(ntiles):
        lo = t * TILE
        length = min(TILE, g.num_edges - lo)
        starts = tile_starts(g, tile_rows, t)[:length]
        assert starts[0] < 0 or int(offsets[tile_rows[t]]) < lo
        row = tile_rows[t]
        for p in range(length):
            row = starts[p] if starts[p] >= 0 else row
            got[lo + p] = row
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threshold", [0.0, 1e-7])
@pytest.mark.parametrize("weights", ["wpr", "val"])
@pytest.mark.parametrize("name", ["rmat10", "tile1", "tile3", "boundaries",
                                  "below_tile", "no_edges"])
def test_k4_model_equals_plain(name, weights, threshold):
    """Three rounds as the card runs them (K3's pass 1, K4's finish with
    the next round's fold) equal pull_power_iters_plain within rtol
    1e-5, with equal change counts."""
    g = _graph(name)
    n = g.num_nodes
    rng = np.random.default_rng(len(name))
    rank = torch.from_numpy(np.where(
        np.arange(g.v_pad) < n, rng.uniform(0.5, 1.5, g.v_pad) / n,
        0.0).astype(np.float32))
    kw = dict(damping=0.85, reset=0.15 / n, threshold=threshold)
    want, want_chg = P.pull_power_iters_plain(g, rank, iters=3,
                                              weights=weights, **kw)
    got, chg = k4_model(g, rank, iters=3, weights=weights, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
    assert chg == want_chg.tolist()
    # the wrapper takes the plain version for CPU tensors
    got, chg = P.pull_power_iters(g, rank, iters=3, weights=weights, **kw)
    assert torch.equal(got, want) and torch.equal(chg, want_chg)


@pytest.mark.parametrize("skew", [False, True])
def test_power_iters_plain_matches_jax(skew):
    """pull_power_iters_plain against the Pallas kernel in interpret
    mode, as tests/test_torch_pr.py holds it, on a uniform graph and on
    one whose hub rows span several of K4's tiles."""
    rng = np.random.default_rng(45)
    n, v_pad, m = 4000, 4096, 30000
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    if skew:
        dst[:3 * TILE + 100] = 7
        dst[3 * TILE + 100:5 * TILE] = 1000
        dst = np.sort(dst)
    jg, pg = _pair(src, dst, None, v_pad, n=n)
    assert skew == (int((pg.csc_offsets[1:] - pg.csc_offsets[:-1]).max())
                    > 2 * TILE)
    d = 0.85
    reset = (1.0 - d) / n
    init = np.where(np.arange(v_pad) < n, 1.0 / n, 0.0).astype(np.float32)
    want, wchg = jpull2.pull_power_iters(
        jg, jnp.asarray(init), iters=4, damping=d, reset=reset,
        threshold=1e-6, interpret=True)
    got, chg = P.pull_power_iters_plain(pg, torch.from_numpy(init), iters=4,
                                        damping=d, reset=reset,
                                        threshold=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-9)
    np.testing.assert_array_equal(chg.numpy(), np.asarray(wchg))
