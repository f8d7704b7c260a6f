"""K14 on the CPU: what ``last_hit_rows`` runs on the card
(``csrc/bfs_kernels.cu`` ``last_hit_rows_kernel``), modelled in numpy
warp by warp, tile by tile and lane by lane, and held against its plain
version (``last_hit_rows_plain``, the chunked ``segment_reduce``).

The kernel cuts the CSC's edges into warp tiles of 256 (lane l holds
edges 8 l .. 8 l + 7), and each warp takes a contiguous run of
``ceil(tiles / warps)`` tiles. A warp finds the row of its first edge by
a binary search of the offsets, then carries into each tile the row of
the edge before it; a tile marks the nonempty rows that start inside it,
reading the offsets 32 rows a step from the one after the carried row
until a row starts at or past the tile's end; a lane's first row is the
largest start before its edges. A hit is its row's last in the tile when
the tile's next hit (in the lane, else the first of the next lane with a
hit) lies in another row; the tile's first and last rows take
``atomicMax``, the rows between them one plain store, and the stores of
all tiles land in a random order here.

Everything here is exact (integers, and float32 sums rounded as the
card rounds one add)."""

import functools
import os
import re

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gunrock_tpu_torch.ops import kernels as K
from test_torch_cuda import HIT_CASES, hit_graph

TILE, LANES = 256, 32
ITEMS = TILE // LANES
MUTATIONS = ("carry_first", "plain_ends", "every_lane")


def _hits(du, dv, w):
    if w is None:   # BFS: int32 labels, the add wrapping as on the card
        return (du.astype(np.uint32) + np.uint32(1)) == dv.astype(np.uint32)
    return (du < dv) & ((du + w).astype(np.float32) == dv)


def k14_model(off, src, vals, w, rows, warps, seed=0, mutate=None):
    """The card's K14 on numpy inputs: (rows,) int64 last hits, -1 where
    none. ``warps``: the grid's warps (the kernel runs one block of 32
    warps an SM)."""
    num_edges = src.shape[0]
    out = np.full(rows, -1, np.int64)
    if num_edges == 0:
        return out
    ntiles = -(-num_edges // TILE)
    per_warp = -(-ntiles // warps)
    stores = []                 # (atomic, row, position)
    for wp in range(warps):
        t, t_end = wp * per_warp, min((wp + 1) * per_warp, ntiles)
        if t >= t_end:
            continue
        lo_r, hi_r = 0, rows
        while hi_r - lo_r > 1:
            mid = (lo_r + hi_r) >> 1
            if off[mid] <= t * TILE:
                lo_r = mid
            else:
                hi_r = mid
        row = lo_r
        for t in range(t, t_end):
            lo, hi = t * TILE, min((t + 1) * TILE, num_edges)
            starts = np.full(TILE, -1, np.int64)
            base = row + 1
            while True:
                r = base + np.arange(LANES)
                inside = r < rows
                s = off[np.minimum(r, rows)]
                past = ~inside | (s >= hi)
                mark = ~past & (off[np.minimum(r + 1, rows)] > s)
                starts[s[mark] - lo] = r[mark]
                if past.any():
                    break
                base += LANES
            st = starts.reshape(LANES, ITEMS)
            incl = np.maximum.accumulate(st.max(1))
            first, last = max(row, st[0, 0]), max(row, incl[-1])
            ends = (-1, -1) if mutate == "plain_ends" else (first, last)
            pend = []           # a lane's (first hit row, last hit row, pos)
            for lane in range(LANES):
                r = row if lane == 0 else max(row, incl[lane - 1])
                n = min(max(hi - lo - ITEMS * lane, 0), ITEMS)
                prow = frow = ppos = -1
                for k in range(n):
                    if st[lane, k] >= 0:
                        r = st[lane, k]
                    e = lo + ITEMS * lane + k
                    if _hits(vals[src[e:e + 1]], vals[r:r + 1],
                             None if w is None else w[e:e + 1])[0]:
                        if prow >= 0 and prow != r:
                            stores.append((prow in ends, prow, ppos))
                        frow = r if frow < 0 else frow
                        prow, ppos = r, e
                pend.append((frow, prow, ppos))
            for lane, (_, prow, ppos) in enumerate(pend):
                nxt = [f for f, p, _ in pend[lane + 1:] if p >= 0]
                if prow >= 0 and (mutate == "every_lane" or not nxt
                                  or nxt[0] != prow):
                    stores.append((prow in ends, prow, ppos))
            row = first if mutate == "carry_first" else last
    plain = [r for a, r, _ in stores if not a]
    assert len(plain) == len(set(plain)), "a row stored twice"
    for i in np.random.default_rng(seed).permutation(len(stores)):
        atomic, r, pos = stores[i]
        out[r] = max(out[r], pos) if atomic else pos
    return out


def _model(dg, vals, w, warps, **kw):
    e = dg.num_edges
    return k14_model(dg.csc_offsets.numpy().astype(np.int64),
                     dg.csc_indices[:e].numpy().astype(np.int64),
                     vals.numpy(), None if w is None else w[:e].numpy(),
                     dg.v_pad, warps, **kw)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(host graph, its upload, BFS labels, SSSP distances) of
    ``test_torch_cuda.hit_graph`` (the R-MAT cases at scale 11)."""
    g = hit_graph(name, scale=11)
    dg = _upload(g)
    root = int(np.argmax(np.diff(dg.row_offsets.numpy())))
    labels, _, _ = gtt.models.bfs_device(dg, root)
    dist, _, _ = gtt.models.sssp_device(dg, root)
    return g, dg, labels, dist


def _upload(g, **kw):
    return gtt.to_device(g, with_csc=True, with_edge_values=True,
                         device="cpu", **kw)


@pytest.mark.parametrize("test", ["bfs", "sssp"])
@pytest.mark.parametrize("name", HIT_CASES)
def test_k14_model_equals_plain(name, test):
    """Both tests over the tile cases, with a grid of 7 warps (runs of
    many tiles) and of one warp a tile, two orders of the stores."""
    _, dg, labels, dist = _case(name)
    vals, w = (labels, None) if test == "bfs" else (dist,
                                                    dg.csc_edge_values)
    want = K.last_hit_rows_plain(dg, vals, w).numpy()
    assert (want >= 0).any() and (want < 0).any()
    ntiles = -(-dg.num_edges // TILE)
    for warps, seed in ((7, 0), (ntiles, 1)):
        np.testing.assert_array_equal(_model(dg, vals, w, warps, seed=seed),
                                      want)


@pytest.mark.parametrize("mutate", MUTATIONS)
def test_k14_model_mutations_are_caught(mutate):
    """Carrying the tile's first row instead of its last, plain stores
    for the rows that cross tiles, and every lane storing its last hit:
    each gives other positions, stores a row twice or marks a start
    outside the tile somewhere."""
    failed = 0
    for name in ("hub", "word_span", "rmat1"):
        _, dg, labels, _ = _case(name)
        want = K.last_hit_rows_plain(dg, labels).numpy()
        for seed in range(3):
            try:
                got = _model(dg, labels, None, 5, seed=seed, mutate=mutate)
            except (AssertionError, IndexError):   # stored twice; a
                failed += 1                        # start outside the tile
                continue
            failed += not np.array_equal(got, want)
    assert failed > 0


def test_tile_is_the_kernels():
    """kHitTile edges a warp tile of K14, 8 a lane."""
    src = open(os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                            "bfs_kernels.cu")).read()
    c = {k: int(v) for k, v in re.findall(
        r"constexpr int(?:64_t)? (k\w+) = (\d+);", src)}
    assert 32 * 4 * c["kHitQuads"] == TILE and 4 * c["kHitQuads"] == ITEMS


def test_int64_offsets_give_the_same_hits():
    """A sizet64 upload's int64 offsets: the model and the plain version
    give the int32 upload's hits."""
    g, dg, labels, dist = _case("rmat1")
    g64 = _upload(g, sizet64=True)
    assert g64.csc_offsets.dtype == torch.int64
    for vals, w32, w64 in ((labels, None, None),
                           (dist, dg.csc_edge_values, g64.csc_edge_values)):
        want = K.last_hit_rows_plain(dg, vals, w32)
        assert torch.equal(K.last_hit_rows(g64, vals, w64), want)
        np.testing.assert_array_equal(_model(g64, vals, w64, 9),
                                      want.numpy())
