"""K1 and K10 on the CPU: what ``pull_reached_words`` and
``bitmask_gather_cumsum`` run on the card (``csrc/bfs_kernels.cu``),
modelled in numpy warp tile by warp tile and lane by lane, and held
against their plain versions and the JAX package's kernels.

K10 cuts its ids into block tiles of ``K.GATHER_CUMSUM_TILE`` (16384):
thread t's quad q holds ids lo + 4096 q + 4 t .. + 3; four ballots a
quad give each lane the hits before it and its warp's total; warp 0
scans the warp-quad totals; tiles pass their totals by a decoupled
look-back, 32 tiles a step, in whatever order the blocks reach it
(seeded random orders here). K1 cuts its edges into warp tiles of
``K.WARP_TILE`` (256); a tile inside one row sets one bit; otherwise
lane l holds edges 8 l .. 8 l + 7; the rows come
from ``csc_offsets`` (the tile-rows prologue, then each row that starts
inside the tile marked at its position, a lane's first row the largest
start before it); a lane folds its edges into runs of one output word,
stores the words strictly inside its runs, and the lanes join their
first and last runs by a segmented OR; every word but the tile's first
and last gets one plain store, those two an atomic OR, and the tiles'
writes land in a random order.

Everything here is exact (integers and bits)."""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu.ops import pallas_kernels as pk
from gunrock_tpu_torch.models.bfs import bfs_device
from gunrock_tpu_torch.ops import kernels as K
from test_torch_cuda import REACH_CASES, reach_graph

TILE = K.WARP_TILE                # K1's warp tile
CTILE = K.GATHER_CUMSUM_TILE      # K10's block tile
LANES, QUADS, WARPS = 32, 4, 32  # K10's quads a thread, warps a block
ITEMS = TILE // LANES             # K1's edges a lane (kReachItems)
INT_MAX = np.iinfo(np.int32).max
K10_MUTATIONS = ("skip_tile", "exclusive")
K1_MUTATIONS = ("no_span_atomic", "row_carry", "head_carry")


def _bits(words, ids):
    """frontier_bit: bit ``ids`` of the packed mask, 0 outside it."""
    w = np.asarray(words).view(np.uint32).astype(np.int64)
    ok = (ids >= 0) & (ids < 32 * w.shape[0])
    if not w.shape[0]:
        return np.zeros(ids.shape, np.int64)
    i = np.where(ok, ids, 0)
    return np.where(ok, (w[i >> 5] >> (i & 31)) & 1, 0)


def lookback(counts, rng, skip=False):
    """Each tile's exclusive prefix as ``warp_lookback`` (tiles.cuh) finds
    it. Tile 0 publishes its inclusive prefix at once; the others look
    back in a random order, adding the counts of the tiles before, 32 at
    a step, up to the nearest that has published its inclusive prefix,
    and then publish theirs. ``skip`` (a mutation) starts one tile
    early, stepping over the tile just before."""
    nt = counts.shape[0]
    incl = {0: int(counts[0])}
    excl = np.zeros(nt, np.int64)
    for c in rng.permutation(np.arange(1, nt)):
        total, base = 0, c - (2 if skip else 1)
        while True:
            js = base - np.arange(32)
            found = [l for l, j in enumerate(js) if j < 0 or j in incl]
            stop = found[0] if found else 31
            for j in js[:stop + 1]:
                if j >= 0:
                    total += incl[j] if j in incl else int(counts[j])
            if found:
                break
            base -= 32
        excl[c] = total
        incl[int(c)] = total + int(counts[c])
    return excl


def k10_model(words, idx, seed=0, mutate=None):
    """The card's K10 on numpy inputs: int32 running sums."""
    n = idx.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    nt = -(-n // CTILE)
    ids = np.full(nt * CTILE, -1, np.int64)
    ids[:n] = idx
    # (tile, quad, warp, lane, item): id lo + 4096 q + 128 w + 4 l + i.
    bits = _bits(words, ids).reshape(nt, QUADS, WARPS, LANES, 4)
    lane = np.arange(LANES)
    ball = (bits << lane[:, None]).sum(3)          # (tile, quad, warp, i)
    below = (1 << lane) - 1
    before = np.bitwise_count(ball[..., None, :] & below[:, None]).sum(-1)
    # The warp-quad totals in id order (entry 32 q + w), scanned by warp
    # 0: lane l sums entries 4 l .. 4 l + 3, scans the sums, then hands
    # each entry the prefix before it.
    v = np.bitwise_count(ball).sum(-1).reshape(nt, LANES, 4)
    x = np.cumsum(v.sum(-1), -1)
    prefix = (x - v.sum(-1))[..., None] + np.cumsum(v, -1) - v
    excl = lookback(x[:, -1], np.random.default_rng(seed),
                    skip=mutate == "skip_tile")
    own = np.cumsum(bits, -1) - (bits if mutate == "exclusive" else 0)
    out = (excl[:, None, None, None, None]
           + prefix.reshape(nt, QUADS, WARPS)[..., None, None]
           + before.astype(np.int64)[..., None] + own)
    return out.reshape(-1)[:n].astype(np.int32)


def tile_rows_model(off, rows, num_edges):
    """``csc_tile_rows_kernel``: each nonempty row writes the tiles whose
    first edge it holds; the slot past the last tile holds ``rows``. Every
    tile is written once."""
    nt = -(-num_edges // TILE)
    t0 = -(-off[:-1] // TILE)
    cnt = np.maximum(-(-off[1:] // TILE) - t0, 0)
    t = np.repeat(t0, cnt) + np.arange(cnt.sum()) - np.repeat(
        np.cumsum(cnt) - cnt, cnt)
    assert np.array_equal(np.sort(t), np.arange(nt))
    tr = np.zeros(nt + 1, np.int64)
    tr[t] = np.repeat(np.arange(rows), cnt)
    tr[nt] = rows
    return tr


def _k1_tile(words, off, src, rows, tr, t, mutate):
    """One warp tile of K1: its writes, as (kind, word, bits) with kind
    "store" or "or"."""
    num_edges = src.shape[0]
    lo = t * TILE
    ln = min(TILE, num_edges - lo)
    row0, row1 = int(tr[t]), int(tr[t + 1])
    ids = np.full(TILE, -1, np.int64)
    ids[:ln] = src[lo:lo + ln]
    hits = _bits(words, ids).reshape(LANES, ITEMS)
    if row0 == row1:
        # The whole tile lies in one row: one bit, an atomic OR.
        kind = "store" if mutate == "no_span_atomic" else "or"
        return [(kind, row0 >> 5, 1 << (row0 & 31))] if hits.any() else []
    # Rows that start inside the tile.
    starts = np.full(TILE, -1, np.int64)
    r = np.arange(row0 + 1, min(row1, rows - 1) + 1)
    s = off[r]
    ok = (s < lo + ln) & (off[r + 1] > s)
    assert np.unique(s[ok]).shape[0] == ok.sum()
    starts[s[ok] - lo] = r[ok]
    st = starts.reshape(LANES, ITEMS)
    last = np.maximum.accumulate(st.max(1))
    first_row = np.maximum(np.concatenate([[-1], last[:-1]]), row0)
    if mutate == "row_carry":
        first_row[:] = row0
    writes = []
    wf = np.full(LANES, INT_MAX, np.int64)
    wl = np.full(LANES, INT_MAX, np.int64)
    bf = np.zeros(LANES, np.int64)
    bl = np.zeros(LANES, np.int64)
    count = np.clip(ln - ITEMS * np.arange(LANES), 0, ITEMS)
    for lane in range(LANES):
        row, wcur, bcur, head = first_row[lane], -1, 0, False
        for k in range(count[lane]):
            if st[lane, k] >= 0:
                row = st[lane, k]
            w = row >> 5
            if w != wcur:
                if wcur >= 0:
                    if not head:
                        wf[lane], bf[lane], head = wcur, bcur, True
                    elif bcur:
                        writes.append(("store", wcur, bcur))
                wcur, bcur = w, 0
            bcur |= int(hits[lane, k]) << int(row & 31)
        if count[lane]:
            wl[lane], bl[lane] = wcur, bcur
            if not head:
                wf[lane], bf[lane] = wcur, 0
    # Segmented OR of the tails over the lanes.
    lanes = np.arange(LANES)
    tail = bl.copy()
    d = 1
    while d < LANES:
        on = (lanes >= d) & (np.roll(wl, d) == wl)
        tail = np.where(on, tail | np.roll(tail, d), tail)
        d *= 2
    prev_wl, prev_tail = np.roll(wl, 1), np.roll(tail, 1)
    next_wf = np.roll(wf, -1)
    first_w, last_w = wf[0], wl[(ln - 1) // ITEMS]

    def put(w, bits):
        if bits:
            span = w in (first_w, last_w) and mutate != "no_span_atomic"
            writes.append(("or" if span else "store", w, bits))

    for lane in range(LANES):
        if wf[lane] != wl[lane]:
            carry = lane > 0 and prev_wl[lane] == wf[lane] and \
                mutate != "head_carry"
            put(wf[lane], bf[lane] | (prev_tail[lane] if carry else 0))
        if count[lane] and (lane == LANES - 1 or next_wf[lane] != wl[lane]):
            put(wl[lane], tail[lane])
    return writes


def k1_model(words, off, src, rows, seed=0, mutate=None):
    """The card's K1 on numpy inputs: (reach words as int32, every write
    as (tile, kind, word, bits)). The tiles' writes land in a random
    order: a store sets its word, an atomic ORs into it."""
    out = np.zeros(-(-rows // 32), np.int64)
    num_edges = src.shape[0]
    if num_edges == 0:
        return out.astype(np.int32), []
    tr = tile_rows_model(off, rows, num_edges)
    nt = tr.shape[0] - 1
    tiles = [_k1_tile(words, off, src, rows, tr, t, mutate)
             for t in range(nt)]
    for t in np.random.default_rng(seed).permutation(nt):
        for kind, w, bits in tiles[t]:
            out[w] = bits if kind == "store" else out[w] | bits
    writes = [(t, *wr) for t in range(nt) for wr in tiles[t]]
    return out.astype(np.uint32).view(np.int32), writes


def _k1(words, g, **kw):
    e = g.num_edges
    return k1_model(np.asarray(words), g.csc_offsets.numpy().astype(np.int64),
                    g.csc_indices[:e].numpy().astype(np.int64), g.v_pad, **kw)


@functools.lru_cache(maxsize=None)
def _rmat(scale):
    """R-MAT ``scale`` (edge factor 16, undirected) uploaded ``with_csc``
    on the CPU, and its frontiers: the packed frontier of each pull level
    of DO-BFS from the largest-degree vertex, a random 0.3 and a sparse
    0.001 one."""
    g = gtt.io.rmat(scale=scale, edge_factor=16, seed=scale, undirected=True)
    dg = gtt.to_device(g, with_csc=True, device="cpu")
    records = []
    labels, _, _ = bfs_device(dg, g.largest_degree_vertex(),
                              direction_optimized=True, instrument=records)
    depths = [r["iteration"] - 1 for r in records if r["phase"] == "pull"]
    assert depths
    rng = np.random.default_rng(scale)
    fronts = [K.pack_bitmask(labels == d) for d in depths]
    fronts += [K.pack_bitmask(torch.from_numpy(rng.random(dg.v_pad) < p))
               for p in (0.3, 0.001)]
    return dg, fronts


@pytest.mark.parametrize("scale", [10, 11, 12])
def test_k10_model_on_pull_levels_equals_plain(scale):
    """Every pull level's frontier, a random and a sparse one, over the
    CSC sources (e_pad ids) and a ragged prefix of them; two orders of
    the look-back."""
    dg, fronts = _rmat(scale)
    idx = dg.csc_indices
    assert idx.shape[0] > CTILE
    for words in fronts:
        for ids in (idx, idx[:idx.shape[0] - 7]):
            want = K.bitmask_gather_cumsum_plain(words, ids).numpy()
            for seed in range(2):
                got = k10_model(words.numpy(), ids.numpy(), seed=seed)
                np.testing.assert_array_equal(got, want)


K10_CASES = [1, CTILE - 1, CTILE, CTILE + 1, 40 * CTILE + 5, "outside"]


@pytest.mark.parametrize("case", K10_CASES)
def test_k10_model_edge_cases_equal_plain(case):
    """One id, around a tile, 41 tiles (look-backs of two steps); ids
    outside a mask that covers half the vertices."""
    rng = np.random.default_rng(7)
    words = K.pack_bitmask(torch.from_numpy(rng.random(4096) < 0.5))
    n = case if isinstance(case, int) else 3 * CTILE + 3
    idx = rng.integers(-50, 4096 + 50, n).astype(np.int32)
    if case == "outside":
        words = words[:words.shape[0] // 2]
    want = K.bitmask_gather_cumsum_plain(words, torch.from_numpy(idx))
    np.testing.assert_array_equal(k10_model(words.numpy(), idx, seed=3),
                                  want.numpy())


@pytest.mark.parametrize("v,n", [(4096, 1024), (1 << 15, 1 << 13)])
def test_k10_model_equals_pallas(v, n):
    """The model against the Pallas kernel in interpret mode, at the
    shapes of tests/test_torch_bfs_pull.py."""
    rng = np.random.default_rng(2)
    mask = rng.integers(0, 2, v).astype(bool)
    words = pk.pack_bitmask(jnp.asarray(mask))
    idx = rng.integers(0, v, n).astype(np.int32)
    want = pk.bitmask_gather_cumsum(words, jnp.asarray(idx), block_rows=2,
                                    interpret=True)
    got = k10_model(np.asarray(words).reshape(-1), idx, seed=1)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("mutate", K10_MUTATIONS)
def test_k10_model_mutations_are_caught(mutate):
    """A look-back that steps over a tile, or sums that leave out each
    id's own bit, fail the comparison."""
    dg, fronts = _rmat(10)
    words = fronts[-2]
    want = K.bitmask_gather_cumsum_plain(words, dg.csc_indices).numpy()
    got = k10_model(words.numpy(), dg.csc_indices.numpy(), mutate=mutate)
    assert not np.array_equal(got, want)


@pytest.mark.parametrize("scale", [10, 11, 12])
def test_k1_model_on_pull_levels_equals_plain(scale):
    """Every pull level's frontier, a random and a sparse one; the model's
    tile rows are written once a tile, and its plain stores are the only
    write of their word."""
    dg, fronts = _rmat(scale)
    for i, words in enumerate(fronts):
        got, writes = _k1(words, dg, seed=i)
        np.testing.assert_array_equal(
            got, K.pull_reached_words_plain(words, dg).numpy())
        stored = [w for _, kind, w, _ in writes if kind == "store"]
        all_words = [w for _, _, w, _ in writes]
        assert len(set(stored)) == len(stored)
        assert all(all_words.count(w) == 1 for w in stored[:200])


@pytest.mark.parametrize("density", [0.001, 0.3])
@pytest.mark.parametrize("name", REACH_CASES)
def test_k1_model_tile_cases_equal_plain(name, density):
    """The tile edge cases of tests/test_torch_cuda.py (a hub row over 20
    tiles, rows starting at tile boundaries, output words spanning
    tiles, long walks over empty rows, a ragged last tile), with the
    whole mask and with half of it (the ids past it read 0)."""
    g = reach_graph(name, "cpu")
    rng = np.random.default_rng(3)
    words = K.pack_bitmask(torch.from_numpy(rng.random(g.v_pad) < density))
    for w in (words, words[:words.shape[0] // 2]):
        got, _ = _k1(w, g, seed=1)
        np.testing.assert_array_equal(
            got, K.pull_reached_words_plain(w, g).numpy())


@pytest.mark.parametrize("seed", [5, 9])
def test_k1_model_equals_jax_blocked_pull(seed):
    """The model against the JAX package's ``pull_reached_words`` on a
    graph uploaded with the blocked CSC (its cells kernel, interpret
    mode), as tests/test_torch_kernels.py builds it."""
    gj = gt.io.rmat(scale=10, edge_factor=6, seed=seed, undirected=True)
    dj = gt.to_device(gj, with_csc=True, with_blocked_csc=True,
                      blocked_block_rows=32)
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 2, dj.v_pad).astype(bool)
    rows = dj.bcsc_groups * dj.bcsc_rows_per_group
    rw = pk.pull_reached_words(pk.pack_bitmask(jnp.asarray(mask), rows=rows),
                               dj, interpret=True)
    want = np.asarray(pk.unpack_bitmask(rw, dj.v_pad))
    dp = gtt.to_device(gtt.io.rmat(scale=10, edge_factor=6, seed=seed,
                                   undirected=True),
                       with_csc=True, device="cpu")
    got, _ = _k1(K.pack_bitmask(torch.from_numpy(mask)), dp)
    np.testing.assert_array_equal(
        K.unpack_bitmask(torch.from_numpy(got), dp.v_pad).numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("mutate", K1_MUTATIONS)
def test_k1_model_mutations_are_caught(mutate):
    """A plain store on a word that spans tiles, a lane that starts at the
    tile's first row, or a head that drops the lanes before it, fail the
    comparison."""
    failed = 0
    for name in ("hub", "word_span"):
        g = reach_graph(name, "cpu")
        words = K.pack_bitmask(torch.from_numpy(
            np.random.default_rng(4).random(g.v_pad) < 0.3))
        got, _ = _k1(words, g, mutate=mutate)
        failed += not np.array_equal(
            got, K.pull_reached_words_plain(words, g).numpy())
    dg, fronts = _rmat(10)
    got, _ = _k1(fronts[-2], dg, mutate=mutate)
    failed += not np.array_equal(
        got, K.pull_reached_words_plain(fronts[-2], dg).numpy())
    assert failed >= 2


def test_tiles_and_caps_are_the_kernels():
    """The wrappers' tiles and size rule are the kernels': kWarpTile edges
    a warp tile of K1, kCumsumTile ids a block tile of K10, and K10's
    mask cap, the 227 KB a block may hold less its own shared memory."""
    src = open(os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                            "bfs_kernels.cu")).read()
    c = {k: int(v) for k, v in re.findall(
        r"constexpr int(?:64_t)? (k\w+) = (\d+);", src)}
    assert 32 * 4 * c["kReachQuads"] == TILE == 256
    assert c["kBlockThreads"] == 32 * WARPS and c["kCumsumQuads"] == QUADS
    assert c["kBlockThreads"] * 4 * QUADS == CTILE == 16384
    assert K.SHARED_MASK_WORDS == (c["kSmemCap"] - c["kCumsumStatic"]) // 4
