"""The CUDA kernels, the BFS paths, SSSP, BC and CC on the card,
against the plain PyTorch versions on the same inputs. Every test here
needs an NVIDIA GPU (marker ``cuda``) and skips without one. The file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gunrock_tpu_torch.ops import kernels as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.001, 0.3, 1.0])
def test_pull_reached_words_kernel_equals_plain(cuda, density):
    g = gtt.to_device(gtt.io.rmat(scale=14, edge_factor=16, seed=7),
                      with_csc=True, device=cuda)
    mask = torch.rand(g.v_pad, device=cuda) < density
    words = K.pack_bitmask(mask)
    before = K.LAUNCHES["pull_reached_words"]
    got = K.pull_reached_words(words, g)
    want = K.pull_reached_words_plain(words, g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.LAUNCHES["pull_reached_words"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1 << 22])
def test_bitmask_gather_kernel_equals_plain(cuda, n):
    words = K.pack_bitmask(torch.rand(1 << 20, device=cuda) < 0.5)
    idx = torch.randint(-100, (1 << 20) + 100, (n,), dtype=torch.int32,
                        device=cuda)
    before = K.LAUNCHES["bitmask_gather"]
    got = K.bitmask_gather(words, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bitmask_gather_plain(words, idx))
    assert K.LAUNCHES["bitmask_gather"] == before + 1
    with pytest.raises(ValueError, match="int32"):
        K.bitmask_gather(words, idx.long())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 127, (1 << 20) + 3])
def test_bitmask_gather_kernel_offsets_equal_plain(cuda, n, offset):
    """K2 exactly: lengths around its 16-byte quads, the ids a view at
    every 4-byte offset mod 16 (as the single-source push slices
    col_indices), ids outside the mask; the output lies at the ids'
    offset mod 16."""
    words = K.pack_bitmask(torch.rand(1 << 20, device=cuda) < 0.5)
    base = torch.randint(-100, (1 << 20) + 100, (n + 8,), dtype=torch.int32,
                         device=cuda)
    idx = base[offset:offset + n]
    assert idx.data_ptr() % 16 == 4 * offset
    got = K.bitmask_gather(words, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bitmask_gather_plain(words, idx))
    assert got.data_ptr() % 16 == idx.data_ptr() % 16


@pytest.mark.cuda
@pytest.mark.parametrize("out_offset", [1, 2, 3])
def test_bitmask_gather_kernel_unaligned_output(cuda, out_offset):
    """The C entry point with ids and output at different offsets mod
    16: every id takes the scalar path, and nothing outside the output
    is written."""
    from gunrock_tpu_torch.ops import _build
    words = K.pack_bitmask(torch.rand(1 << 16, device=cuda) < 0.5)
    n = 100_003
    idx = torch.randint(-5, (1 << 16) + 5, (n,), dtype=torch.int32,
                        device=cuda)
    want = K.bitmask_gather_plain(words, idx)
    buf = torch.full((n + 4,), 7, dtype=torch.int32, device=cuda)
    out = buf[out_offset:out_offset + n]
    K._launch(_build.load().gr_bitmask_gather, words.data_ptr(),
              words.shape[0] * 32, idx.data_ptr(), n, out.data_ptr(),
              device=idx.device)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert (buf[:out_offset] == 7).all() and (buf[out_offset + n:] == 7).all()


@pytest.mark.cuda
def test_bitmask_gather_kernel_mask_above_the_cap_and_hub_slice(cuda):
    """K2 over a mask above the shared-memory cap that K10 keeps (read
    through L1 as every mask is), and at the single-source push's own
    launch: the largest-degree vertex's neighbours sliced from
    col_indices."""
    big = K.pack_bitmask(torch.rand(32 * (K.SHARED_MASK_WORDS + 1),
                                    device=cuda) < 0.5)
    idx = torch.randint(-3, big.shape[0] * 32 + 3,
                        (40 * big.shape[0] + 5,), dtype=torch.int32,
                        device=cuda)
    got = K.bitmask_gather(big, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bitmask_gather_plain(big, idx))
    dg = gtt.to_device(gtt.io.rmat(scale=14, edge_factor=16, seed=3,
                                   undirected=True), device=cuda)
    deg = dg.row_offsets[1:] - dg.row_offsets[:-1]
    hub = int(torch.argmax(deg))
    start, end = dg.row_offsets[hub:hub + 2].tolist()
    nbr = dg.col_indices[start:end]
    words = K.pack_bitmask(torch.rand(dg.v_pad, device=cuda) < 0.5)
    got = K.bitmask_gather(words, nbr)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bitmask_gather_plain(words, nbr))


@pytest.mark.cuda
def test_bfs_on_cuda_equals_cpu_and_launches_kernels(cuda):
    g = gtt.io.rmat(scale=10, edge_factor=8, seed=42, undirected=True)
    want = gtt.bfs(g, "largestdegree", mark_preds=True,
                   direction_optimized=True, alpha=0.05, device="cpu")
    K.reset_launch_counts()
    got = gtt.bfs(g, "largestdegree", mark_preds=True,
                  direction_optimized=True, alpha=0.05, device="cuda")
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.preds, want.preds)
    assert K.LAUNCHES["pull_reached_words"] > 0
    assert K.LAUNCHES["bitmask_gather"] > 0


@pytest.mark.cuda
def test_bfs_k1_launches_lie_in_pull_level_spans(cuda):
    """The program's spans on the profiler's clock: every K1 launch of
    a DO-BFS (its runtime call, matched by correlation id) lies inside a
    ``bfs.level`` span of kind ``pull``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gunrock_tpu_torch.enactor import tracing
    g = gtt.io.rmat(scale=14, edge_factor=16, seed=7, undirected=True)
    src = g.largest_degree_vertex()
    dg = gtt.to_device(g, with_csc=True, with_blocked_csc=True, device=cuda)
    gtt.bfs(dg, src, mark_preds=True, direction_optimized=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing() as spans:
            gtt.bfs(dg, src, mark_preds=True, direction_optimized=True)
    evs = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in evs
              if e.device_type() != DeviceType.CUDA
              and e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
    k1 = [launch.get(e.correlation_id()) for e in evs
          if e.device_type() == DeviceType.CUDA
          and "pull_reached_words_kernel" in e.name()]
    pulls = [(s, e) for _, _, _, name, s, e, attrs in spans
             if name == "bfs.level" and attrs.get("kind") == "pull"]
    assert k1 and pulls and None not in k1
    assert all(any(s <= t <= e for s, e in pulls) for t in k1)


@pytest.mark.cuda
def test_bfs_run_record_on_the_card_at_flagship_size(cuda):
    """``edges_visited`` and ``search_depth``, reduced on the card, equal
    the numpy formula on the flagship R-MAT (scale 20, edge factor 32)
    uploaded with int32 offsets and as sizet64; a second call's record
    (one read of both, then ``make_info``) takes under 5 ms."""
    g = gtt.io.rmat(scale=20, edge_factor=32, seed=1, undirected=True)
    src = g.largest_degree_vertex()
    deg = np.diff(g.row_offsets.astype(np.int64))
    for kw in ({"with_blocked_csc": True}, {"sizet64": True}):
        dg = gtt.to_device(g, with_csc=True, device=cuda, **kw)
        assert dg.row_offsets.dtype == (torch.int64 if "sizet64" in kw
                                        else torch.int32)
        for _ in range(2):
            r = gtt.bfs(dg, src, mark_preds=True, direction_optimized=True)
            assert (r.info["edges_visited"], r.info["search_depth"]) == (
                int(deg[r.labels >= 0].sum()), int(r.labels.max(initial=0)))
        assert r.info["record_ms"] < 5.0
        del dg


@pytest.mark.cuda
@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_bfs_takes_a_graph_uploaded_with_the_default_device(cuda, device):
    """``gtt.bfs(gtt.to_device(g, ...))`` with the defaults: the upload
    lands on cuda:0 and ``device="cuda"`` names that card."""
    g = gtt.io.rmat(scale=10, edge_factor=8, seed=42, undirected=True)
    want = gtt.bfs(g, "largestdegree", mark_preds=True,
                   direction_optimized=True, device="cpu")
    dg = gtt.to_device(g, with_csc=True, with_blocked_csc=True)
    kw = {} if device is None else {"device": device}
    got = gtt.bfs(dg, g.largest_degree_vertex(), mark_preds=True,
                  direction_optimized=True, **kw)
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, (1 << 20) + 3, "rmat"])
def test_bitmask_gather_cumsum_kernel_equals_plain(cuda, n):
    """K10 against its plain version, exactly: short and ragged lengths,
    one past a tile boundary, and the CSC sources of an R-MAT graph
    (e_pad ids), with ids outside the mask."""
    words = K.pack_bitmask(torch.rand(1 << 20, device=cuda) < 0.5)
    if n == "rmat":
        g = gtt.to_device(gtt.io.rmat(scale=12, edge_factor=16, seed=3,
                                      undirected=True),
                          with_csc=True, device=cuda)
        idx = g.csc_indices
    else:
        idx = torch.randint(-100, (1 << 20) + 100, (n,), dtype=torch.int32,
                            device=cuda)
    before = K.LAUNCHES["bitmask_gather_cumsum"]
    got = K.bitmask_gather_cumsum(words, idx)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bitmask_gather_cumsum"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, K.bitmask_gather_cumsum_plain(words, idx))


@pytest.mark.cuda
def test_bfs_without_blocked_csc_pulls_through_k10(cuda):
    """DO-BFS on a graph uploaded with_csc only pulls through K10 and
    never K1; its labels and predecessors equal the CPU run's."""
    g = gtt.io.rmat(scale=12, edge_factor=16, seed=3, undirected=True)
    src = g.largest_degree_vertex()
    want = gtt.bfs(g, src, mark_preds=True, direction_optimized=True,
                   device="cpu")
    dg = gtt.to_device(g, with_csc=True, device=cuda)
    K.reset_launch_counts()
    records = []
    labels, preds, _ = gtt.models.bfs_device(
        dg, src, mark_preds=True, direction_optimized=True,
        instrument=records)
    torch.cuda.synchronize()
    pulls = [r["phase"] for r in records].count("pull")
    assert pulls > 0 and K.LAUNCHES["bitmask_gather_cumsum"] == pulls
    assert K.LAUNCHES["pull_reached_words"] == 0
    n = g.num_nodes
    np.testing.assert_array_equal(labels[:n].cpu().numpy(), want.labels)
    np.testing.assert_array_equal(preds[:n].cpu().numpy(), want.preds)


# Graphs whose CSC puts K1's edges where its warp tiles of
# K.WARP_TILE edges are hard (also modelled on the CPU in
# tests/test_torch_bfs_tiles.py).
REACH_CASES = ["hub", "tile_starts", "word_span", "sparse_rows"]


def reach_case(name):
    """(num_nodes, src, dst) of a directed graph, by CSC row (dst):
    ``hub``: row 0 holds 100 edges, row 1 the next 20 tiles and 7 edges,
    then 300 empty rows, then rows of 0-3 edges, the edge count 3 mod 4
    (a ragged last tile and 16-byte loads); ``tile_starts``: 8 rows of
    exactly one tile each, so rows start at tile boundaries, then rows of
    one edge; ``word_span``: rows 0-31 (one output word) of 40 edges each
    span three tiles, rows 32-95 hold one edge and rows 96-127 (one
    word) hold 16 each, across a tile boundary; ``sparse_rows``: 3000
    edges into random rows of 2^16, most rows empty, so the walks over
    csc_offsets are long."""
    rng = np.random.default_rng(len(name))
    tile = K.WARP_TILE
    if name == "hub":
        n = 8192
        deg = np.zeros(n, np.int64)
        deg[0], deg[1] = 100, 20 * tile + 7
        deg[302:] = rng.integers(0, 4, n - 302) * (rng.random(n - 302) < 0.5)
        deg[302] += (3 - deg.sum()) % 4
    elif name == "tile_starts":
        n = 4096
        deg = np.zeros(n, np.int64)
        deg[:8], deg[8:48] = tile, 1
    elif name == "word_span":
        n = 1024
        deg = np.zeros(n, np.int64)
        deg[:32], deg[32:96], deg[96:128] = 40, 1, 16
    else:
        n = 1 << 16
        deg = np.bincount(rng.integers(0, n, 3000), minlength=n)
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, dst.shape[0])
    return n, src, dst


def reach_graph(name, device):
    n, src, dst = reach_case(name)
    return gtt.to_device(gtt.from_coo(n, src, dst, remove_self_loops=False,
                                      dedup=False),
                         with_csc=True, device=device)


# K14's tile cases (also modelled on the CPU in
# tests/test_torch_hit_tiles.py): K1's, and R-MAT graphs cut to edge
# counts at residues 0, 1 and 255 of its 256-edge warp tile.
HIT_CASES = REACH_CASES + ["rmat0", "rmat1", "rmat255"]


def hit_graph(name, scale):
    """A directed host graph of ``HIT_CASES`` (the R-MAT cases at
    ``scale``, edge factor 16: hubs whose rows span many tiles, empty
    rows), built ``from_coo(dedup=False)`` with float32 weights in [0, 1),
    a tenth of them 0 and a tenth 2^-26 (absorbed by most adds), so that
    ties occur."""
    if name.startswith("rmat"):
        g = gtt.io.rmat(scale=scale, edge_factor=16, seed=7, undirected=True)
        n = g.num_nodes
        dst = np.repeat(np.arange(n), np.diff(g.row_offsets))
        src = g.col_indices.astype(np.int64)
        tile = 256
        keep = src.shape[0] - (src.shape[0] - int(name[4:])) % tile
        src, dst = src[:keep], dst[:keep]
    else:
        n, src, dst = reach_case(name)
    rng = np.random.default_rng(len(name))
    w = rng.random(src.shape[0]).astype(np.float32)
    pick = rng.random(src.shape[0])
    w[pick < 0.1] = 0.0
    w[(pick >= 0.1) & (pick < 0.2)] = np.float32(2.0**-26)
    return gtt.from_coo(n, src, dst, values=w, remove_self_loops=False,
                        dedup=False)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.001, 0.3])
@pytest.mark.parametrize("name", REACH_CASES)
def test_pull_reached_words_kernel_tiles_equal_plain(cuda, name, density):
    """K1 exactly on the tile edge cases, with the whole mask and with
    half of it (the ids past it read 0)."""
    g = reach_graph(name, cuda)
    rng = np.random.default_rng(3)
    words = K.pack_bitmask(torch.from_numpy(
        rng.random(g.v_pad) < density).to(cuda))
    for w in (words, words[:words.shape[0] // 2]):
        got = K.pull_reached_words(w, g)
        torch.cuda.synchronize()
        assert torch.equal(got, K.pull_reached_words_plain(w, g))


def _above_cap_graph(cuda):
    g = gtt.io.rmat(scale=21, edge_factor=4, seed=1, undirected=True)
    return gtt.to_device(g, with_csc=True, device=cuda)


@pytest.mark.cuda
def test_pull_reached_words_kernel_on_a_large_mask(cuda):
    """R-MAT scale 21: a mask of 65,536 words, above what K10 holds in
    shared memory; K1, which reads its mask through L1 at every size,
    exactly."""
    g = _above_cap_graph(cuda)
    words = K.pack_bitmask(torch.rand(g.v_pad, device=cuda) < 0.1)
    assert words.shape[0] > K.SHARED_MASK_WORDS
    before = K.LAUNCHES["pull_reached_words"]
    got = K.pull_reached_words(words, g)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pull_reached_words"] == before + 1
    assert torch.equal(got, K.pull_reached_words_plain(words, g))


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n", [1, 511, 512, 513, 33 * 512 + 5,
                               (1 << 22) + 3, "unaligned"])
def test_bitmask_gather_cumsum_kernel_variants_equal_plain(cuda, n, shared):
    """K10 with its mask in shared memory and through L1, exactly: one
    id, around a warp tile, many tiles, and ids that start 4 bytes past
    a 16-byte boundary (one id at a time)."""
    words = K.pack_bitmask(torch.rand(1 << 20, device=cuda) < 0.5)
    m = (1 << 20) + 1 if n == "unaligned" else n
    idx = torch.randint(-100, (1 << 20) + 100, (m,), dtype=torch.int32,
                        device=cuda)
    if n == "unaligned":
        idx = idx[1:]
    got = K._gather_cumsum(words, idx, shared)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bitmask_gather_cumsum_plain(words, idx))


@pytest.mark.cuda
def test_bitmask_gather_cumsum_kernel_above_the_cap(cuda):
    """The CSC sources of R-MAT scale 21 under a mask of more words than
    the shared variant holds: the wrapper reads it through L1, exactly;
    the shared variant refuses it."""
    g = _above_cap_graph(cuda)
    words = K.pack_bitmask(torch.rand(g.v_pad, device=cuda) < 0.3)
    assert words.shape[0] > K.SHARED_MASK_WORDS
    got = K.bitmask_gather_cumsum(words, g.csc_indices)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bitmask_gather_cumsum_plain(words,
                                                          g.csc_indices))
    with pytest.raises(RuntimeError, match="CUDA error"):
        K._gather_cumsum(words, g.csc_indices, True)


def _value_graph(cuda, scale=14):
    g = gtt.io.rmat(scale=scale, edge_factor=16, seed=7, undirected=True)
    g.random_edge_values(seed=7)
    return g, gtt.to_device(g, with_csc=True, with_edge_values=True,
                            with_edge_src=True, with_blocked_values=True,
                            device=cuda)


# K3's modes: (op, wmode, weights, with init). ``min`` is exact; sums
# accumulate in float32 in the kernel and in float64 in the plain version.
PULL_MODES = [("sum", "none", "val", False), ("sum", "mul", "wpr", False),
              ("sum", "add", "val", True), ("min", "add", "val", False),
              ("min", "none", "val", True), ("min", "incr", "val", False),
              ("sum", "mul", "val", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("op,wmode,weights,with_init", PULL_MODES)
def test_pull_reduce2_kernel_equals_plain(cuda, op, wmode, weights,
                                          with_init):
    from gunrock_tpu_torch.ops import pull2 as P
    _, g = _value_graph(cuda)
    # a hub row spans tiles (one of three and more: _tile_graph)
    assert int((g.csc_offsets[1:] - g.csc_offsets[:-1]).max()) > \
        P.PULL_TILE
    vals = torch.rand(g.v_pad, device=cuda)
    init = torch.rand(g.v_pad, device=cuda) if with_init else None
    before = K.LAUNCHES["pull_reduce2"]
    got = P.pull_reduce2(vals, g, op=op, wmode=wmode, init=init,
                         weights=weights)
    again = P.pull_reduce2(vals, g, op=op, wmode=wmode, init=init,
                           weights=weights)
    want = P.pull_reduce2_plain(vals, g, op=op, wmode=wmode, init=init,
                                weights=weights)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pull_reduce2"] == before + 2
    assert torch.equal(got, again)          # deterministic, bit for bit
    if op == "min":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_pull_reduce2_kernel_edge_cases(cuda):
    """No edges; one row holding every edge; rows of exactly one tile."""
    from gunrock_tpu_torch.ops import pull2 as P
    for src, dst, n in (([], [], 300),
                        (list(range(1, 5000)), [0] * 4999, 5000),
                        (list(range(2 * P.PULL_TILE)),
                         [1] * P.PULL_TILE + [2] * P.PULL_TILE,
                         2 * P.PULL_TILE)):
        g = gtt.to_device(gtt.from_coo(n, np.array(src, np.int64),
                                       np.array(dst, np.int64)),
                          with_csc=True, with_blocked_values=True,
                          device=cuda)
        vals = torch.rand(g.v_pad, device=cuda)
        for op in ("sum", "min"):
            got = P.pull_reduce2(vals, g, op=op)
            want = P.pull_reduce2_plain(vals, g, op=op)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def _tile_graph(cuda, residue):
    """A directed graph whose CSC puts the edges where K3's tiles are
    hard: row 2 starts exactly at the second tile; row 2 is a hub of
    three tiles and more; rows 3-99 and the last 50 rows are empty, and
    the rest hold 0-3 edges with runs of empty rows between; the edge
    count is ``residue`` mod 4 (the 16-byte loads' ragged end) and no
    multiple of the tile. Edge values for the ``val`` weights."""
    from gunrock_tpu_torch.ops import pull2 as P
    tile = P.PULL_TILE
    rng = np.random.default_rng(residue)
    n = 4 * tile
    deg = np.zeros(n, np.int64)
    deg[0], deg[1], deg[2] = tile - 5, 5, 3 * tile + 7
    body = rng.integers(0, 4, n - 150) * (rng.random(n - 150) < 0.5)
    deg[100:n - 50] = body
    deg[100] += (residue - deg.sum()) % 4
    assert deg.sum() % 4 == residue and deg.sum() % tile
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, dst.shape[0])
    vals = rng.uniform(0.0, 64.0, dst.shape[0]).astype(np.float32)
    g = gtt.from_coo(n, src, dst, vals, remove_self_loops=False, dedup=False)
    dg = gtt.to_device(g, with_csc=True, with_edge_values=True,
                       with_blocked_values=True, device=cuda)
    assert dg.num_edges == deg.sum()
    assert int(dg.csc_offsets[2]) == tile
    return dg


@pytest.mark.cuda
@pytest.mark.parametrize("residue", [1, 2, 3])
@pytest.mark.parametrize("op,wmode,weights,with_init", PULL_MODES)
def test_pull_reduce2_kernel_tile_edges(cuda, residue, op, wmode, weights,
                                        with_init):
    """K3 at its tile's edge cases (see _tile_graph), every mode: bitwise
    equal over two launches, min exact, sums within rtol 1e-5 of the
    float64-summing plain version."""
    from gunrock_tpu_torch.ops import pull2 as P
    g = _tile_graph(cuda, residue)
    vals = torch.rand(g.v_pad, device=cuda)
    init = torch.rand(g.v_pad, device=cuda) if with_init else None
    kw = dict(op=op, wmode=wmode, init=init, weights=weights)
    got = P.pull_reduce2(vals, g, **kw)
    again = P.pull_reduce2(vals, g, **kw)
    want = P.pull_reduce2_plain(vals, g, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if op == "min":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("residue", [1, 3])
def test_pull_passes_on_tile_edges_equal_plain(cuda, residue):
    """K4 and K6, which run K3's pass, on the tile edge-case graph."""
    from gunrock_tpu_torch.ops import pull2 as P
    g = _tile_graph(cuda, residue)
    n = g.num_nodes
    start = torch.full((g.v_pad,), 1.0 / n, device=cuda)
    kw = dict(iters=3, damping=0.85, reset=0.15 / n, threshold=1e-6,
              weights="val")
    rank, chg = P.pull_power_iters(g, start, **kw)
    want, want_chg = P.pull_power_iters_plain(g, start, **kw)
    init = torch.full((g.v_pad,), float("inf"), device=cuda)
    init[:8] = 0.0
    dist, dchg = P.pull_min_sweeps(g, init, sweeps=4)
    wdist, wdchg = P.pull_min_sweeps_plain(g, init, sweeps=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(rank, want, rtol=1e-4, atol=1e-9)
    assert torch.equal(chg, want_chg)
    assert torch.equal(dist, wdist) and torch.equal(dchg, wdchg)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 4, 7])
def test_pull_power_iters_kernel_equals_plain(cuda, iters):
    from gunrock_tpu_torch.ops import pull2 as P
    _, g = _value_graph(cuda)
    n = g.num_nodes
    init = torch.where(torch.arange(g.v_pad, device=cuda) < n, 1.0 / n,
                       0.0).float()
    kw = dict(iters=iters, damping=0.85, reset=0.15 / n, threshold=1e-6)
    before = K.LAUNCHES["pull_power_iters"]
    rank, chg = P.pull_power_iters(g, init, **kw)
    want, want_chg = P.pull_power_iters_plain(g, init, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pull_power_iters"] == before + 1
    torch.testing.assert_close(rank, want, rtol=1e-4, atol=1e-9)
    assert chg.dtype == torch.int32 and chg.shape == (iters,)
    assert torch.equal(chg, want_chg)


def _boundary_graph(cuda):
    """Empty rows at tile boundaries: rows 0-4 empty before the first
    edge, rows ending exactly at the first three tile ends with empty
    rows after them, a row holding a tile's last edge alone, two whole
    tiles in one row."""
    from gunrock_tpu_torch.ops import pull2 as P
    tile = P.PULL_TILE
    deg = np.zeros(64, np.int64)
    deg[5], deg[12], deg[13] = tile, tile - 3, 3
    deg[20], deg[21], deg[22] = tile - 1, 1, 2 * tile
    rng = np.random.default_rng(11)
    dst = np.repeat(np.arange(64), deg)
    src = rng.integers(0, 64, dst.shape[0])
    vals = rng.uniform(0.0, 64.0, dst.shape[0]).astype(np.float32)
    return gtt.to_device(gtt.from_coo(64, src, dst, vals, dedup=False,
                                      remove_self_loops=False),
                         with_csc=True, with_edge_values=True,
                         with_blocked_values=True, device=cuda)


def _below_tile_graph(cuda):
    from gunrock_tpu_torch.ops import pull2 as P
    rng = np.random.default_rng(9)
    m = P.PULL_TILE - 3
    src, dst = rng.integers(0, 700, m), rng.integers(0, 700, m)
    vals = rng.uniform(0.0, 8.0, m).astype(np.float32)
    return gtt.to_device(gtt.from_coo(700, src, dst, vals, dedup=False,
                                      remove_self_loops=False),
                         with_csc=True, with_edge_values=True,
                         with_blocked_values=True, device=cuda)


def _power_graph(cuda, name):
    if name == "rmat":
        return _value_graph(cuda)[1]
    if name.startswith("tile"):
        return _tile_graph(cuda, int(name[4:]))
    return {"below_tile": _below_tile_graph,
            "boundaries": _boundary_graph}[name](cuda)


POWER_GRAPHS = ["rmat", "tile1", "tile3", "below_tile", "boundaries"]


def _power_k3(g, rank, *, iters, damping, reset, threshold, weights):
    """K4's rounds composed from K3: pull_reduce2 sum/mul, then the
    epilogue and the change count in torch (float32, one rounding an
    operation, as the kernel's _rn intrinsics)."""
    from gunrock_tpu_torch.ops import pull2 as P
    vmask = torch.arange(g.v_pad, device=rank.device) < g.num_nodes
    d32 = torch.tensor(damping, dtype=torch.float32, device=rank.device)
    r32 = torch.tensor(reset, dtype=torch.float32, device=rank.device)
    changed = []
    for _ in range(iters):
        acc = P.pull_reduce2(rank, g, op="sum", wmode="mul", weights=weights)
        fresh = torch.where(vmask, r32 + d32 * acc, 0.0)
        changed.append(((fresh - rank).abs() > threshold).sum())
        rank = fresh
    return rank, torch.stack(changed).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["wpr", "val"])
@pytest.mark.parametrize("iters", [1, 4, 7, 20])
@pytest.mark.parametrize("name", POWER_GRAPHS)
def test_pull_power_iters_kernel_equals_k3_composition(cuda, name, iters,
                                                       weights):
    """K4 bitwise equal to its composition from K3 and to a second launch,
    with equal change counts, on R-MAT and the tile edge-case graphs: a
    hub row over three tiles and more at 1 and 3 edges mod 4, fewer edges
    than one tile, empty rows at tile boundaries."""
    from gunrock_tpu_torch.ops import pull2 as P
    g = _power_graph(cuda, name)
    n = g.num_nodes
    rng = np.random.default_rng(iters)
    init = torch.from_numpy(np.where(
        np.arange(g.v_pad) < n, rng.uniform(0.5, 1.5, g.v_pad) / n,
        0.0).astype(np.float32)).to(cuda)
    kw = dict(iters=iters, damping=0.85, reset=0.15 / n, threshold=1e-7,
              weights=weights)
    before = K.LAUNCHES["pull_power_iters"]
    rank, chg = P.pull_power_iters(g, init, **kw)
    again, again_chg = P.pull_power_iters(g, init, **kw)
    want, want_chg = _power_k3(g, init, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pull_power_iters"] == before + 2
    assert torch.equal(rank, again) and torch.equal(chg, again_chg)
    assert torch.equal(rank, want)
    assert torch.equal(chg, want_chg)


@pytest.mark.cuda
@pytest.mark.parametrize("prim", ["pagerank", "hits", "salsa"])
def test_value_primitives_on_cuda_equal_cpu(cuda, prim):
    g, dg = _value_graph(cuda, scale=12)
    K.reset_launch_counts()
    if prim == "pagerank":
        got = gtt.pagerank(dg, max_iters=20, threshold=0.0)
        dc = gtt.to_device(g, with_csc=True, with_blocked_values=True,
                           device="cpu")
        want = gtt.pagerank(dc, max_iters=20, threshold=0.0)
        assert K.LAUNCHES["pull_power_iters"] > 0
        np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-3,
                                   atol=1e-9)
        assert got.info["num_iterations"] == want.info["num_iterations"]
        loop = gtt.pagerank(dg, max_iters=20, threshold=0.0,
                            instrumented=True)
        assert K.LAUNCHES["pull_reduce2"] == 20
        np.testing.assert_allclose(loop.ranks, got.ranks, rtol=1e-4,
                                   atol=1e-9)
        # The host graph is uploaded with_csc only: the loop route, K3.
        host = gtt.pagerank(g, max_iters=20, threshold=0.0, device="cuda")
        assert K.LAUNCHES["pull_reduce2"] == 40
        np.testing.assert_allclose(host.ranks, got.ranks, rtol=1e-4,
                                   atol=1e-9)
        return
    got = getattr(gtt, prim)(g, max_iters=10, device="cuda")
    want = getattr(gtt, prim)(g, max_iters=10, device="cpu")
    assert K.LAUNCHES["pull_reduce2"] == 20
    atol = 1e-4 if prim == "hits" else 1e-5
    np.testing.assert_allclose(got.hubs, want.hubs, rtol=1e-3, atol=atol)
    np.testing.assert_allclose(got.auths, want.auths, rtol=1e-3, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("two,pos64", [(False, False), (False, True),
                                       (True, False), (True, True)])
def test_sample_sorted_kernel_equals_plain(cuda, two, pos64):
    n = 1 << 20
    a = torch.rand(n, device=cuda)
    b = torch.randint(0, 1 << 30, (n,), dtype=torch.int32, device=cuda)
    pos = torch.sort(torch.randint(-5, n + 5, (3_000_001,),
                                   device=cuda)).values
    pos = pos if pos64 else pos.to(torch.int32)
    name = "sample_sorted2" if two else "sample_sorted"
    before = K.LAUNCHES[name]
    if two:
        got = K.sample_sorted2(b, a, pos)
        want = K.sample_sorted2_plain(b, a, pos)
    else:
        got = (K.sample_sorted(a, pos),)
        want = (K.sample_sorted_plain(a, pos),)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("pos64", [False, True])
@pytest.mark.parametrize("n", range(1, 10))
def test_sample_sorted_kernel_small_and_unaligned(cuda, n, pos64, two):
    """K5 at 1-9 positions (the quads and the last n % 4 positions), with
    the positions and the arrays 0-3 elements (4-12 bytes) off a 16-byte
    boundary, positions out of range on both sides, one and two arrays."""
    rng = np.random.default_rng(n)
    length = 50
    for off in range(4):
        a = torch.from_numpy(rng.random(length + off).astype(np.float32))
        b = torch.from_numpy(rng.integers(-9, 9, length + off,
                                          dtype=np.int32))
        a, b = a.to(cuda)[off:], b.to(cuda)[off:]
        p = np.sort(rng.integers(-3, length + 3, n + off))
        pos = torch.from_numpy(p.astype(np.int64 if pos64 else np.int32))
        pos = pos.to(cuda)[off:]
        assert pos.data_ptr() % 16 == (off * pos.element_size()) % 16
        if two:
            got = K.sample_sorted2(b, a, pos)
            want = K.sample_sorted2_plain(b, a, pos)
        else:
            got = (K.sample_sorted(a, pos),)
            want = (K.sample_sorted_plain(a, pos),)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y), (off, x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["min", "sum", "filtered", "overflow",
                                  "giant", "aligned", "empty"])
def test_reduce_by_dst_sorted_kernel_equals_plain(cuda, case):
    """ids and count exact, min exact, sum within rtol 1e-6 of the float64
    plain version, bitwise equal over two launches. ``aligned``: runs
    that begin exactly at a tile's first lane and span several tiles."""
    g = torch.Generator(device=cuda).manual_seed(3)
    m, nv, out_lanes = {"min": (3_000_000, 200_000, 200_000),
                        "sum": (3_000_000, 200_000, 200_000),
                        "filtered": (3_000_000, 200_000, 200_000),
                        "overflow": (500_000, 400_000, 1000),
                        "giant": (300_000, 3, 16),
                        "aligned": (40 * K.REDUCE_TILE, 10, 16),
                        "empty": (0, 1, 16)}[case]
    sd = torch.sort(torch.randint(0, nv, (m,), generator=g, device=cuda,
                                  dtype=torch.int32)).values
    if case == "aligned":     # run i covers tiles 4i..4i+3
        sd = torch.arange(m, device=cuda, dtype=torch.int32) // (
            4 * K.REDUCE_TILE)
    vals = torch.rand(m, generator=g, device=cuda) * 10
    aux = None
    if case == "filtered":
        aux = (torch.rand(nv, generator=g, device=cuda) * 10)[sd.long()]
    op = "sum" if case in ("sum", "giant", "aligned") else "min"
    kw = dict(op=op, out_lanes=out_lanes, aux=aux)
    before = K.LAUNCHES["reduce_by_dst_sorted"]
    ids, rv, cnt = K.reduce_by_dst_sorted(sd, vals, **kw)
    ids2, rv2, cnt2 = K.reduce_by_dst_sorted(sd, vals, **kw)
    wid, wrv, wcnt = K.reduce_by_dst_sorted_plain(sd, vals, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["reduce_by_dst_sorted"] == before + 2
    assert cnt.dtype == torch.int32 and int(cnt) == int(wcnt)
    k = min(int(cnt), out_lanes)
    assert (int(cnt) > out_lanes) == (case == "overflow")
    assert torch.equal(ids[:k], wid[:k]) and torch.equal(ids[:k], ids2[:k])
    assert torch.equal(rv[:k], rv2[:k])
    if op == "min":
        assert torch.equal(rv[:k], wrv[:k])
    else:
        torch.testing.assert_close(rv[:k], wrv[:k], rtol=1e-6, atol=0)


# The K7 edge cases, shared with tests/test_torch_reduce_tiles.py, which
# runs them through a numpy model of the kernel on the CPU.
REDUCE_CASES = ["span2", "span3", "span40", "aligned", "m0", "m1",
                "tile_minus_1", "tile", "tile_plus_1", "one_key",
                "overflow", "aux_rejects_all", "aux_keeps_all", "inf"]


def _runs(lengths, rng, m):
    """Sorted keys made of runs of the given lengths, then runs of 1-12
    lanes up to ``m``; ids rise by 1-3 from run to run."""
    lengths = list(lengths)
    while sum(lengths) < m:
        lengths.append(int(rng.integers(1, 13)))
    ids = np.cumsum(rng.integers(1, 4, len(lengths)))
    return np.repeat(ids, lengths)[:m].astype(np.int32)


def reduce_case(name, op, seed=0):
    """(sd, vals, aux, out_lanes) of a K7 edge case, in numpy: runs over
    2, 3 and 40 tiles; runs that begin at a tile's first lane; lengths 0,
    1 and about a tile; every lane one key; ``out_lanes`` crossed inside
    the second tile; aux that rejects every run and none; +-inf values
    with BC's +-inf aux."""
    rng = np.random.default_rng(seed)
    t = K.REDUCE_TILE
    aux = None
    if name.startswith("span"):
        tiles = int(name[4:])
        m = (tiles + 2) * t
        sd = _runs([t - 300, (tiles - 2) * t + 300 + 500], rng, m)
    elif name == "aligned":   # runs start at tiles 1, 2 and 5 exactly
        m = 7 * t + 11
        sd = _runs([t, t, 3 * t, 5, t - 5], rng, m)
    elif name in ("m0", "m1", "tile_minus_1", "tile", "tile_plus_1"):
        m = {"m0": 0, "m1": 1, "tile_minus_1": t - 1, "tile": t,
             "tile_plus_1": t + 1}[name]
        sd = _runs([], rng, m)
    elif name == "one_key":
        m = 5 * t + 7
        sd = np.full(m, 7, np.int32)
    else:
        m = 3 * t + 5
        sd = _runs([], rng, m)
    vals = (rng.random(m) * 10).astype(np.float32)
    ids, first = np.unique(sd, return_index=True)
    runs = ids.shape[0]
    out_lanes = runs + 64
    if name == "overflow":    # runs of tile 0, and 100 more
        out_lanes = int(np.searchsorted(first, t)) + 100
    elif name in ("aux_rejects_all", "aux_keeps_all"):
        bound = -np.inf if name == "aux_rejects_all" else np.inf
        aux = np.full(m, bound, np.float32)
    elif name == "inf":
        vals[rng.random(m) < 0.05] = -np.inf if op == "sum" else np.inf
        vals[rng.random(m) < 0.02] = -np.inf
        if op == "sum":       # one sign of infinity a run: no NaN
            vals[(sd % 2 == 1) & np.isinf(vals)] = 0.0
        per_run = np.where(rng.random(runs) < 0.5, np.inf, -np.inf)
        aux = per_run[np.searchsorted(ids, sd)].astype(np.float32)
    return sd, vals, aux, out_lanes


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "sum"])
@pytest.mark.parametrize("name", REDUCE_CASES)
def test_reduce_by_dst_sorted_kernel_edge_cases(cuda, name, op):
    """K7 on its edge cases against the plain version (ids, count and min
    exact, sum within rtol 1e-6) and bitwise over two launches."""
    sd, vals, aux, out_lanes = reduce_case(name, op)
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda)
    kw = dict(op=op, out_lanes=out_lanes, aux=t(aux))
    ids, rv, cnt = K.reduce_by_dst_sorted(t(sd), t(vals), **kw)
    ids2, rv2, cnt2 = K.reduce_by_dst_sorted(t(sd), t(vals), **kw)
    wid, wrv, wcnt = K.reduce_by_dst_sorted_plain(t(sd), t(vals), **kw)
    torch.cuda.synchronize()
    assert int(cnt) == int(wcnt) == int(cnt2)
    k = min(int(cnt), out_lanes)
    assert (int(cnt) > out_lanes) == (name == "overflow")
    if name == "aux_rejects_all":
        assert int(cnt) == 0
    assert torch.equal(ids[:k], wid[:k]) and torch.equal(ids[:k], ids2[:k])
    assert torch.equal(rv[:k], rv2[:k])
    if op == "min":
        assert torch.equal(rv[:k], wrv[:k])
    else:
        torch.testing.assert_close(rv[:k], wrv[:k], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_reduce_by_dst_sorted_kernel_on_a_side_stream(cuda):
    """K7 launched on a non-default stream equals its launch on the
    default one, and waits for nothing else."""
    sd, vals, _, out_lanes = reduce_case("span3", "sum", seed=5)
    sd, vals = torch.from_numpy(sd).to(cuda), torch.from_numpy(vals).to(cuda)
    want = K.reduce_by_dst_sorted(sd, vals, op="sum", out_lanes=out_lanes)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = K.reduce_by_dst_sorted(sd, vals, op="sum", out_lanes=out_lanes)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    k = int(want[2])
    assert int(got[2]) == k
    assert torch.equal(got[0][:k], want[0][:k])
    assert torch.equal(got[1][:k], want[1][:k])


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "max", "add", "set"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("offset", [0, 1])
def test_scatter_sorted_kernel_equals_plain(cuda, op, dtype, offset):
    """Counts on the host and on the device: all lanes, far fewer than
    the buffer (the grid strides over the live lanes only), none, one
    not a multiple of 4 and more than the buffer. ``offset`` 1 starts
    ids and vals 4 bytes past a 16-byte boundary (no vector loads)."""
    n = 1 << 20
    ids = torch.unique(torch.randint(0, n + 100, (300_000,), device=cuda,
                                     dtype=torch.int32))
    if dtype == torch.float32:
        vals = torch.randn(ids.shape[0], device=cuda) * 10
        dense = torch.randn(n, device=cuda) * 10
    else:
        vals = torch.randint(-100, 100, ids.shape, device=cuda,
                             dtype=torch.int32)
        dense = torch.randint(-100, 100, (n,), device=cuda,
                              dtype=torch.int32)
    ids, vals = ids[offset:], vals[offset:]
    m = ids.shape[0]

    def dev(c):
        return torch.tensor(c, dtype=torch.int32, device=cuda)

    for count in (None, 1234, dev(5000), 0, dev(0), dev(4097), m + 10,
                  dev(m + 10)):
        before = K.LAUNCHES["scatter_sorted"]
        got = K.scatter_sorted(dense.clone(), ids, vals, count=count, op=op)
        want = K.scatter_sorted_plain(dense.clone(), ids, vals,
                                      count=None if count is None
                                      else int(count), op=op)
        torch.cuda.synchronize()
        assert K.LAUNCHES["scatter_sorted"] == before + 1
        assert torch.equal(got, want)


def _sweeps_equal(g, init, sweeps, wmode):
    """K6 against its plain version, distances and counts bit for bit;
    returns the distances."""
    from gunrock_tpu_torch.ops import pull2 as P
    got, chg = P.pull_min_sweeps(g, init, sweeps=sweeps, wmode=wmode)
    want, wchg = P.pull_min_sweeps_plain(g, init, sweeps=sweeps, wmode=wmode)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(chg, wchg), chg.tolist()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("wmode", ["add", "incr", "none"])
def test_pull_min_sweeps_kernel_equals_plain(cuda, wmode):
    """Jacobi sweeps: distances and change counts equal, from a single
    finite seed (the first sweep gathers one source's edges), from every
    vertex finite (CC's labels), and in a continuation call from a state
    that is not a fixpoint (every finite source active again)."""
    from gunrock_tpu_torch.ops import pull2 as P
    _, g = _value_graph(cuda)
    seed = torch.full((g.v_pad,), float("inf"), device=cuda)
    seed[0] = 0.0
    inits = [seed]
    if wmode == "none":
        inits.append(torch.arange(g.v_pad, device=cuda, dtype=torch.float32))
    before = K.LAUNCHES["pull_min_sweeps"]
    for init in inits:
        for sweeps in (1, 6):
            _sweeps_equal(g, init, sweeps, wmode)
        mid, _ = P.pull_min_sweeps_plain(g, init, sweeps=2, wmode=wmode)
        _sweeps_equal(g, mid, 3, wmode)
    assert K.LAUNCHES["pull_min_sweeps"] == before + 3 * len(inits)


def _hub_graph(cuda):
    """A directed graph for K6's quiet tiles: row 0 holds half a tile,
    row 1 (the hub) the next three tiles, so it spans tiles 0-3 (head,
    two middle, tail); the sources of the hub's edges in tile c come from
    range c of HUB_RANGES alone; then rows of 0-3 edges from the upper
    vertices, a twentieth of them from the hub itself. Weights uniform in
    [0, 64) with a tenth zero; sources repeat. Returns (graph, ranges)."""
    from gunrock_tpu_torch.ops import pull2 as P
    tile = P.PULL_TILE
    rng = np.random.default_rng(5)
    n = 16 * tile
    ranges = [(4096 * (c + 1), 4096 * (c + 2)) for c in range(4)]
    hub_pos = np.arange(tile // 2, tile // 2 + 3 * tile)
    hub_src = np.empty(hub_pos.shape[0], np.int64)
    for c, (lo, hi) in enumerate(ranges):
        at = hub_pos // tile == c
        hub_src[at] = rng.integers(lo, hi, int(at.sum()))
    deg = np.zeros(n, np.int64)
    deg[0], deg[1] = tile // 2, 3 * tile
    deg[2:] = rng.integers(0, 4, n - 2)
    dst = np.repeat(np.arange(n), deg)
    src = np.empty(dst.shape[0], np.int64)
    src[:tile // 2] = rng.integers(*ranges[0], tile // 2)
    src[tile // 2:tile // 2 + 3 * tile] = hub_src
    rest = dst.shape[0] - 7 * tile // 2
    src[7 * tile // 2:] = np.where(rng.random(rest) < 0.05, 1,
                                   rng.integers(ranges[3][1], n, rest))
    vals = rng.uniform(0.0, 64.0, dst.shape[0]).astype(np.float32)
    vals[rng.random(dst.shape[0]) < 0.1] = 0.0
    g = gtt.from_coo(n, src, dst, vals, remove_self_loops=False, dedup=False)
    dg = gtt.to_device(g, with_csc=True, with_edge_values=True,
                       with_blocked_values=True, device=cuda)
    offs = dg.csc_offsets.cpu().numpy()
    assert offs[1] == tile // 2 and offs[2] == 7 * tile // 2
    return dg, ranges


@pytest.mark.cuda
@pytest.mark.parametrize("skip", ["head", "middle", "tail"])
@pytest.mark.parametrize("wmode", ["add", "incr", "none"])
def test_pull_min_sweeps_kernel_skips_tiles(cuda, wmode, skip):
    """K6 with the hub row's head (tile 0, also row 0's only tile), middle
    (tiles 1-2) or tail tile (3, also the first small rows' only tile)
    quiet in the first sweep: only the sources of the other hub tiles are
    finite. Later sweeps find every hub tile quiet, over the partials the
    first sweep left. Distances and counts equal the plain version's."""
    g, ranges = _hub_graph(cuda)
    quiet = {"head": [0], "middle": [1, 2], "tail": [3]}[skip]
    rng = np.random.default_rng(len(skip))
    init = np.full(g.v_pad, np.inf, np.float32)
    for c, (lo, hi) in enumerate(ranges):
        if c not in quiet:
            init[lo:hi] = rng.uniform(0.0, 100.0, hi - lo).astype(np.float32)
    init = torch.from_numpy(init).to(cuda)
    _sweeps_equal(g, init, 4, wmode)
    _sweeps_equal(g, init, 1, wmode)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["below_tile", 1, 2, 3])
@pytest.mark.parametrize("wmode", ["add", "incr", "none"])
def test_pull_min_sweeps_kernel_small_and_ragged(cuda, wmode, size):
    """K6 on fewer edges than one tile, and on the tile edge-case graph at
    1, 2 and 3 edges mod 4 (the 16-byte loads' ragged end): eight seeds,
    then a continuation call."""
    from gunrock_tpu_torch.ops import pull2 as P
    if size == "below_tile":
        rng = np.random.default_rng(9)
        m = P.PULL_TILE - 3
        src, dst = rng.integers(0, 700, m), rng.integers(0, 700, m)
        vals = rng.uniform(0.0, 8.0, m).astype(np.float32)
        g = gtt.to_device(gtt.from_coo(700, src, dst, vals, dedup=False,
                                       remove_self_loops=False),
                          with_csc=True, with_edge_values=True,
                          with_blocked_values=True, device=cuda)
        assert g.num_edges < P.PULL_TILE
    else:
        g = _tile_graph(cuda, size)
    init = torch.full((g.v_pad,), float("inf"), device=cuda)
    init[:8] = torch.arange(8, device=cuda, dtype=torch.float32)
    first = _sweeps_equal(g, init, 1, wmode)
    _sweeps_equal(g, first, 5, wmode)


def _brandes_k3(g, lab, sig, delta, *, fwd, level0, levels):
    """K9's levels composed from K3: pull_reduce2 sum/none over the gated
    values, then the epilogue in torch (float32, as the plain version)."""
    from gunrock_tpu_torch.ops import pull2 as P
    counts = []
    for r in range(levels):
        if fwd:
            d = level0 + r
            acc = P.pull_reduce2(torch.where(lab == float(d - 1), sig, 0.0), g)
            open_ = lab == float("inf")
            sig = torch.where(open_, sig + acc, sig)
            new = open_ & (sig > 0)
            lab = torch.where(new, float(d), lab)
            counts.append(new.sum())
        else:
            t = level0 - r
            gated = torch.where(lab == float(t + 1),
                                (1.0 + delta) / sig.clamp(min=1e-30), 0.0)
            acc = P.pull_reduce2(gated, g)
            ring = lab == float(t)
            delta = torch.where(ring, sig * (delta + acc), delta)
            counts.append(ring.sum())
    return lab, sig, delta, torch.stack(counts).to(torch.int32)


def _grid_device(cuda, n):
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    g = gtt.from_coo(n * n, src, dst, undirected=True)
    return g, gtt.to_device(g, with_edge_src=True, with_blocked_values=True,
                            device=cuda)


def _brandes_graph(cuda, name):
    if name == "grid":
        return _grid_device(cuda, 64)
    return _value_graph(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_brandes_levels_kernel_equals_k3_composition(cuda, name):
    """K9 in calls of 3 levels, every level of both phases, bitwise equal
    to its composition from K3 (the gated sources and live rows change
    nothing): labels, sigma, delta and counts. On the R-MAT graph hub
    rows span tiles; the grid's phases run 126 levels."""
    from gunrock_tpu_torch.ops import pull2 as P
    g, dg = _brandes_graph(cuda, name)
    src = g.largest_degree_vertex() if name == "rmat" else 0
    lab = torch.full((dg.v_pad,), float("inf"), device=cuda)
    lab[src] = 0.0
    sig = torch.zeros(dg.v_pad, device=cuda)
    sig[src] = 1.0
    d, depth = 1, None
    while depth is None:
        got = P.brandes_fwd_levels(dg, lab, sig, d0=d, levels=3)
        want = _brandes_k3(dg, lab, sig, None, fwd=True, level0=d, levels=3)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2], want[3])
        lab, sig, chg = got
        if 0 in chg.tolist():
            depth = d + chg.tolist().index(0) - 1
        d += 3
    delta = torch.zeros(dg.v_pad, device=cuda)
    for t in range(depth - 1, -1, -3):
        n = min(3, t + 1)
        got = P.brandes_bwd_levels(dg, lab, sig, delta, t0=t, levels=n)
        want = _brandes_k3(dg, lab, sig, delta, fwd=False, level0=t, levels=n)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[2]) and torch.equal(got[1], want[3])
        delta = got[0]
    assert depth > (100 if name == "grid" else 3)


@pytest.mark.cuda
def test_brandes_levels_kernel_past_the_depth(cuda):
    """K9 at levels past the last: forward levels and backward rings with
    nobody to gate or update count 0 and leave the state bit for bit."""
    from gunrock_tpu_torch.ops import pull2 as P
    g, dg = _value_graph(cuda)
    src = g.largest_degree_vertex()
    lab = torch.full((dg.v_pad,), float("inf"), device=cuda)
    lab[src] = 0.0
    sig = torch.zeros(dg.v_pad, device=cuda)
    sig[src] = 1.0
    lab, sig, chg = P.brandes_fwd_levels(dg, lab, sig, d0=1, levels=16)
    depth = chg.tolist().index(0)
    assert 0 < depth and not any(chg.tolist()[depth:])
    lab2, sig2, chg2 = P.brandes_fwd_levels(dg, lab, sig, d0=depth + 2,
                                            levels=3)
    delta = torch.rand(dg.v_pad, device=cuda)
    delta2, ring = P.brandes_bwd_levels(dg, lab, sig, delta, t0=depth + 4,
                                        levels=2)
    torch.cuda.synchronize()
    assert chg2.tolist() == [0, 0, 0] and ring.tolist() == [0, 0]
    assert torch.equal(lab2, lab) and torch.equal(sig2, sig)
    assert torch.equal(delta2, delta)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bellman", "nearfar"])
def test_sssp_on_cuda_equals_cpu(cuda, mode, monkeypatch):
    g = gtt.io.rmat(scale=12, edge_factor=16, seed=5, undirected=True)
    g.random_edge_values(seed=5)
    want = gtt.sssp(g, "largestdegree", mark_preds=True, mode=mode,
                    delta_factor=0.5, device="cpu")
    K.reset_launch_counts()
    got = gtt.sssp(g, "largestdegree", mark_preds=True, mode=mode,
                   delta_factor=0.5, device="cuda")
    np.testing.assert_array_equal(got.distances, want.distances)
    np.testing.assert_array_equal(got.preds, want.preds)
    assert got.info["num_iterations"] == want.info["num_iterations"]
    assert K.LAUNCHES["sample_sorted"] > 0 and K.LAUNCHES["sample_sorted2"] > 0
    # The device graph with the blocked values: the sweep route (K6),
    # then fused and pulling push rounds (K7, K8, K3) on the same graph.
    dg = gtt.to_device(g, with_edge_values=True, with_blocked_values=True,
                       device=cuda)
    dist, _, stats = gtt.models.sssp_device(dg, got.info["src"])
    assert stats.route == "pull_sweeps" and K.LAUNCHES["pull_min_sweeps"] > 0
    assert np.array_equal(dist[:g.num_nodes].cpu().numpy(), want.distances)
    monkeypatch.setenv("GUNROCK_SSSP_PULL2", "0")   # bellman pushes
    fused, _, stats = gtt.models.sssp_device(dg, got.info["src"], mode=mode,
                                             delta=16.0, fused=True)
    assert torch.equal(fused, dist) and stats.route == mode
    assert K.LAUNCHES["reduce_by_dst_sorted"] > 0
    assert K.LAUNCHES["scatter_sorted"] > 0
    if mode == "bellman":   # the hub's second round passes E / 16
        assert K.LAUNCHES["pull_reduce2"] > 0


@pytest.mark.cuda
def test_wrappers_refuse_device_mixes(cuda):
    from gunrock_tpu_torch.ops import pull2 as P
    x = torch.rand(100, device=cuda)
    pos = torch.arange(10)
    with pytest.raises(ValueError, match="tensors on"):
        K.sample_sorted(x, pos)
    with pytest.raises(ValueError, match="tensors on"):
        K.reduce_by_dst_sorted(torch.zeros(5, dtype=torch.int32, device=cuda),
                               torch.zeros(5), out_lanes=4)
    with pytest.raises(ValueError, match="tensors on"):
        K.scatter_sorted(x, torch.zeros(3, dtype=torch.int32),
                         torch.zeros(3))
    _, g = _value_graph(cuda, scale=10)
    with pytest.raises(ValueError, match="tensors on"):
        P.pull_min_sweeps(g, torch.zeros(g.v_pad), sweeps=2)


def _bc_graph(cuda):
    """An undirected R-MAT graph with has_pull2 (the kernel-C route)."""
    g = gtt.io.rmat(scale=12, edge_factor=8, seed=11, undirected=True)
    dg = gtt.to_device(g, with_edge_src=True, with_blocked_values=True,
                       device=cuda)
    assert dg.has_pull2 and dg.undirected
    return g, dg


@pytest.mark.cuda
def test_brandes_levels_kernel_equals_plain(cuda):
    """K9, both phases from the largest-degree vertex in calls of 4
    levels: labels and counts exact, sigma and delta within rtol 1e-5 of
    the float64-summing plain version, bitwise equal over two launches."""
    from gunrock_tpu_torch.ops import pull2 as P
    g, dg = _bc_graph(cuda)
    src = g.largest_degree_vertex()
    lab = torch.full((dg.v_pad,), float("inf"), device=cuda)
    lab[src] = 0.0
    sig = torch.zeros(dg.v_pad, device=cuda)
    sig[src] = 1.0
    before = K.LAUNCHES["brandes_levels"]
    d, depth = 1, None
    while depth is None:
        got = P.brandes_fwd_levels(dg, lab, sig, d0=d, levels=4)
        again = P.brandes_fwd_levels(dg, lab, sig, d0=d, levels=4)
        want = P.brandes_fwd_levels_plain(dg, lab, sig, d0=d, levels=4)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        lab, sig, chg = got
        if 0 in chg.tolist():
            depth = d + chg.tolist().index(0) - 1
        d += 4
    delta = torch.zeros(dg.v_pad, device=cuda)
    for t in range(depth - 1, -1, -4):
        n = min(4, t + 1)
        got = P.brandes_bwd_levels(dg, lab, sig, delta, t0=t, levels=n)
        again = P.brandes_bwd_levels(dg, lab, sig, delta, t0=t, levels=n)
        want = P.brandes_bwd_levels_plain(dg, lab, sig, delta, t0=t,
                                          levels=n)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        delta = got[0]
    assert K.LAUNCHES["brandes_levels"] > before + 2


@pytest.mark.cuda
def test_bc_routes_on_cuda_agree(cuda, monkeypatch):
    """bc_device on CUDA: kernel C (K9), the hybrid (K3 on big levels) and
    the fused hybrid (K5, K7, K8) agree with each other and with the
    float64 oracle."""
    from gunrock_tpu_torch.models import bc_device
    from gunrock_tpu_torch.utils import reference as oracle
    g, dg = _bc_graph(cuda)
    src = g.largest_degree_vertex()
    K.reset_launch_counts()
    bc2, sig2, lab2, st2 = bc_device(dg, src)
    assert st2.route == "pull2" and K.LAUNCHES["brandes_levels"] > 0
    monkeypatch.setenv("GUNROCK_BC_PULL2", "0")
    for fused in (False, True):
        K.reset_launch_counts()
        bc1, sig1, lab1, st1 = bc_device(dg, src, fused=fused)
        torch.cuda.synchronize()
        assert st1.route == "hybrid" and K.LAUNCHES["pull_reduce2"] > 0
        if fused:
            assert K.LAUNCHES["sample_sorted"] > 0
            assert K.LAUNCHES["reduce_by_dst_sorted"] > 0
            assert K.LAUNCHES["scatter_sorted"] > 0
        assert torch.equal(lab1, lab2)
        torch.testing.assert_close(sig1, sig2, rtol=1e-5, atol=0)
        torch.testing.assert_close(bc1, bc2, rtol=1e-4, atol=1e-4)
    n = g.num_nodes
    labels, sigma, delta = oracle.cpu_brandes(g, src)
    np.testing.assert_array_equal(lab2[:n].cpu().numpy(), labels)
    np.testing.assert_allclose(sig2[:n].cpu().numpy(), sigma, rtol=1e-5)
    delta[src] = 0.0
    np.testing.assert_allclose(bc2[:n].cpu().numpy(), delta, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.cuda
def test_cc_on_cuda_equals_scipy(cuda, monkeypatch):
    """CC on CUDA, hooking and the sweeps route (K6), against scipy's
    components."""
    from gunrock_tpu_torch.utils import reference as oracle
    g, dg = _bc_graph(cuda)
    want = oracle.cpu_cc(g)
    res = gtt.cc(dg)
    np.testing.assert_array_equal(res.components, want)
    assert res.num_components == len(np.unique(want))
    host = gtt.cc(g, device="cuda")
    np.testing.assert_array_equal(host.components, want)
    monkeypatch.setenv("GUNROCK_CC_SWEEPS", "1")
    K.reset_launch_counts()
    sweeps = gtt.cc(dg)
    assert sweeps.info["route"] == "pull_sweeps"
    assert K.LAUNCHES["pull_min_sweeps"] > 0
    np.testing.assert_array_equal(sweeps.components, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3, 7])
def test_pagerank_directed_iterations_on_cuda(cuda, seed):
    """PageRank's float32 routes on the card on directed R-MAT graphs
    (ROADMAP.md queue C, C3): the loop route (K3) stops where a float64
    power iteration with the same rule stops, and the power route (K4,
    forced on this small graph) first counts no moved vertex at that
    iteration; the ranks within the CPU route's tolerance of the plain
    version."""
    import dataclasses
    from gunrock_tpu_torch.models.pr import pagerank_device
    g = gtt.io.rmat(scale=9, edge_factor=8, seed=seed, undirected=False)
    n = g.num_nodes
    esrc = g.edge_sources()
    deg = np.diff(g.row_offsets).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    rank = np.full(n, 1.0 / n)
    want_iters = 50
    for it in range(1, 51):
        new = 0.15 / n + 0.85 * np.bincount(
            g.col_indices, weights=(rank * inv)[esrc], minlength=n)
        moved = int((np.abs(new - rank) > 1e-6).sum())
        rank = new
        if moved == 0:
            want_iters = it
            break
    want = gtt.pagerank(g, device="cpu")
    assert want.info["num_iterations"] == want_iters
    dg = gtt.to_device(g, with_csc=True, device=cuda)
    K.reset_launch_counts()
    loop = gtt.pagerank(dg)
    assert loop.info["num_iterations"] == want_iters
    assert K.LAUNCHES["pull_reduce2"] == want_iters
    np.testing.assert_allclose(loop.ranks, want.ranks, rtol=1e-4, atol=2e-7)
    r, _, stats = pagerank_device(dataclasses.replace(dg, has_pull2=True))
    torch.cuda.synchronize()
    assert K.LAUNCHES["pull_power_iters"] > 0
    assert stats.frontier_trace.index(0) + 1 == want_iters
    # The power route stops after a chunk of rounds: against its plain
    # version over the same rounds.
    plain, _, pstats = pagerank_device(dataclasses.replace(
        gtt.to_device(g, with_csc=True, device="cpu"), has_pull2=True))
    assert pstats.iteration == stats.iteration
    np.testing.assert_allclose(r.cpu().numpy()[:n], plain.numpy()[:n],
                               rtol=1e-4, atol=2e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, "4096"])
def test_tc_on_cuda_equals_cpu(cuda, budget, monkeypatch):
    """TC on the card against the plain PyTorch path: the total, every
    count and the chunking, in one chunk and in many."""
    from gunrock_tpu_torch.utils.reference import cpu_tc
    if budget:
        monkeypatch.setenv("GUNROCK_TC_WEDGE_BUDGET", budget)
    g = gtt.io.rmat(scale=12, edge_factor=16, seed=3, undirected=True)
    got = gtt.tc(g, device="cuda")
    want = gtt.tc(g, device="cpu")
    assert got.total == want.total == cpu_tc(g) > 0
    np.testing.assert_array_equal(got.edge_counts, want.edge_counts)
    np.testing.assert_array_equal(got.vertex_counts, want.vertex_counts)
    for key in ("num_chunks", "wedges_probed", "edges_visited"):
        assert got.info[key] == want.info[key], key
    assert (got.info["num_chunks"] > 1) == bool(budget)
    assert got.info["gpuinfo"]["platform"] == "gpu"


@pytest.mark.cuda
def test_operators_on_cuda_equal_cpu(cuda):
    """expand_inverse, pull_reduce, cull_filter and sample on the card
    against the same functions on the CPU, on the same inputs."""
    from gunrock_tpu_torch.ops import (cull_filter, expand_inverse,
                                       pull_reduce)
    g = gtt.io.rmat(scale=12, edge_factor=8, seed=4)
    dc = gtt.to_device(g, with_csc=True, device="cpu")
    dg = gtt.to_device(g, with_csc=True, device=cuda)
    hub = g.largest_degree_vertex()
    frontier = torch.tensor([hub, 0, 7], dtype=torch.int32)
    exc, exg = expand_inverse(dc, frontier), expand_inverse(dg,
                                                            frontier.cuda())
    assert exg.total == exc.total > 0
    for f in ("src", "dst", "eid", "rank"):
        assert torch.equal(getattr(exg, f).cpu(), getattr(exc, f)), f
    keep = exc.dst % 3 != 0
    fc = cull_filter(exc.dst, keep, size=dc.v_pad)
    fg = cull_filter(exg.dst, keep.cuda(), size=dg.v_pad)
    assert fg[1] == fc[1] and torch.equal(fg[0].cpu(), fc[0])
    assert torch.equal(fg[2].cpu(), fc[2])
    rng = np.random.default_rng(5)
    for vals in (rng.uniform(0.5, 1.5, dc.e_pad).astype(np.float32),
                 rng.integers(-99, 99, dc.e_pad).astype(np.int32)):
        v = torch.from_numpy(vals)
        for op in ("sum", "max", "min"):
            want = pull_reduce(dc, v, op=op)
            got = pull_reduce(dg, v.cuda(), op=op).cpu()
            if op == "sum" and v.dtype.is_floating_point:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
            else:
                assert torch.equal(got, want), op
    np.testing.assert_array_equal(gtt.sample(dg, hub),
                                  gtt.sample(dc, hub))


@pytest.mark.cuda
def test_sssp_carry_on_cuda_equals_cpu(cuda):
    """The value-carry micro-loop on the card: bitwise the CPU's and the
    plain route's distances and counts; its rounds launch K5's pair mode
    alone, so the carry run launches ``sample_sorted`` fewer times."""
    n = 128
    idx = np.arange(n * n).reshape(n, n)
    g = gtt.from_coo(n * n, np.concatenate([idx[:, :-1].ravel(),
                                            idx[:-1, :].ravel()]),
                     np.concatenate([idx[:, 1:].ravel(),
                                     idx[1:, :].ravel()]), undirected=True)
    g.random_edge_values(seed=11)
    delta = 32.0 * float(np.mean(g.edge_values))
    dg = gtt.to_device(g, with_edge_values=True, device=cuda)
    dc = gtt.to_device(g, with_edge_values=True, device="cpu")
    launches = {}
    runs = {}
    for carry in (False, True):
        K.reset_launch_counts()
        runs[carry] = gtt.models.sssp_device(dg, 0, mode="nearfar",
                                             delta=delta, deep_carry=carry)
        torch.cuda.synchronize()
        launches[carry] = dict(K.LAUNCHES)
    want, _, wstats = gtt.models.sssp_device(dc, 0, mode="nearfar",
                                             delta=delta, deep_carry=True)
    for dist, _, stats in runs.values():
        assert torch.equal(dist.cpu(), want)
        assert (stats.iteration, stats.edges_queued) == \
            (wstats.iteration, wstats.edges_queued)
    assert launches[True]["sample_sorted2"] == \
        launches[False]["sample_sorted2"] > 0
    assert launches[True]["sample_sorted"] < launches[False]["sample_sorted"]


# Past 2^31: the sizet64 routes' lengths. Each test holds 16-24 GiB.
PAST_2_31 = (1 << 31) + (1 << 20) + 3


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_bitmask_gather_cumsum_kernel_wraps_past_2_31(cuda, shared):
    """K10 over 2^31 + 2^20 + 3 ids, every one a hit: its int32 sums wrap
    modulo 2^32 past 2^31, bitwise equal to the plain version, compared
    in chunks that carry the plain running sum (``start``)."""
    words = K.pack_bitmask(torch.ones(1024, dtype=torch.bool, device=cuda))
    idx = torch.zeros(PAST_2_31, dtype=torch.int32, device=cuda)
    got = K._gather_cumsum(words, idx, shared)
    torch.cuda.synchronize()
    assert int(got[(1 << 31) - 2]) == 2**31 - 1
    assert int(got[(1 << 31) - 1]) == -2**31
    assert int(got[-1]) == PAST_2_31 - 2**32
    carry, chunk = 0, 1 << 28
    for lo in range(0, PAST_2_31, chunk):
        want = K.bitmask_gather_cumsum_plain(words, idx[lo:lo + chunk],
                                             start=carry)
        assert torch.equal(got[lo:lo + chunk], want), lo
        carry = int(want[-1])


@pytest.mark.cuda
def test_bitmask_gather_kernel_past_2_31_ids(cuda):
    """K2 over 2^31 + 2^20 + 3 ids (an int64 length): equal to the plain
    version at the head, across 2^31 and at the tail."""
    words = K.pack_bitmask(torch.rand(1 << 16, device=cuda) < 0.5)
    idx = torch.randint(0, 1 << 16, (PAST_2_31,), dtype=torch.int32,
                        device=cuda)
    got = K.bitmask_gather(words, idx)
    torch.cuda.synchronize()
    for lo in (0, (1 << 31) - (1 << 20), PAST_2_31 - (1 << 20)):
        sl = slice(lo, lo + (1 << 20))
        assert torch.equal(got[sl], K.bitmask_gather_plain(words, idx[sl]))


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True])
def test_sample_sorted_kernel_int64_positions_past_2_31(cuda, two):
    """K5 reading an array of 2^31 + 2^20 + 3 entries at int64 positions
    on both sides of 2^31 (and past the end, which read 0)."""
    a = torch.randint(0, 1 << 30, (PAST_2_31,), dtype=torch.int32,
                      device=cuda)
    pos = torch.cat([torch.arange(0, 4096, device=cuda),
                     torch.arange((1 << 31) - 2048, (1 << 31) + 2048,
                                  device=cuda),
                     torch.arange(PAST_2_31 - 100, PAST_2_31 + 100,
                                  device=cuda)])
    if two:
        b = a.view(torch.float32)
        ga, gb = K.sample_sorted2(a, b, pos)
        wa, wb = K.sample_sorted2_plain(a, b, pos)
        torch.cuda.synchronize()
        assert torch.equal(ga, wa) and torch.equal(gb.view(torch.int32),
                                                   wb.view(torch.int32))
    else:
        got = K.sample_sorted(a, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, K.sample_sorted_plain(a, pos))


@pytest.mark.cuda
def test_int32_count_kernels_refuse_2_31_lanes(cuda):
    """K7 and K8 keep their counts in int32 by design: their wrappers
    refuse a stream of 2^31 lanes (expanded views: nothing is allocated,
    the refusal comes first) instead of wrapping."""
    sd = torch.zeros(1, dtype=torch.int32, device=cuda).expand(1 << 31)
    vals = torch.zeros(1, device=cuda).expand(1 << 31)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        K.reduce_by_dst_sorted(sd, vals, out_lanes=16)
    dense = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        K.scatter_sorted(dense, sd, vals, count=4)


@pytest.mark.cuda
def test_sizet64_graph_on_cuda_equals_int32(cuda):
    """A flagship-shaped graph (R-MAT scale 16) uploaded with sizet64 and
    with int32 offsets: DO-BFS with preds (K10; its pushes are micro
    rounds at this size), near-far SSSP fused
    (K5, K7, K8) and PageRank's loop route (K3 over narrowed row bounds)
    bitwise equal; the narrowed bounds are refused past 2^31 edges."""
    import dataclasses
    from gunrock_tpu_torch.models.bfs import bfs_device
    from gunrock_tpu_torch.models.pr import pagerank_device
    from gunrock_tpu_torch.models.sssp import sssp_device
    g = gtt.io.rmat(scale=16, edge_factor=16, seed=5, undirected=True)
    g.random_edge_values(seed=7)
    kw = dict(with_csc=True, with_edge_values=True, device=cuda)
    d64 = gtt.to_device(g, sizet64=True, **kw)
    d32 = gtt.to_device(g, **kw)
    assert d64.csc_offsets.dtype == torch.int64
    src = g.largest_degree_vertex()
    K.reset_launch_counts()
    for fn in (lambda d: bfs_device(d, src, mark_preds=True,
                                    direction_optimized=True)[:2],
               lambda d: sssp_device(d, src, mark_preds=True,
                                     mode="nearfar", fused=True)[:2],
               lambda d: pagerank_device(d)[:1]):
        for a, b in zip(fn(d64), fn(d32)):
            assert torch.equal(a, b)
    for name in ("bitmask_gather_cumsum", "sample_sorted2",
                 "reduce_by_dst_sorted", "scatter_sorted", "pull_reduce2"):
        assert K.LAUNCHES[name] > 0, name
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        K.pull_reached_words(K.pack_bitmask(torch.ones(
            d64.v_pad, dtype=torch.bool, device=cuda)),
            dataclasses.replace(d64, num_edges=2**31))


def _sharded_graph(cuda, scale=12):
    """R-MAT at ``scale`` with weights, partitioned into 4 shards of the
    card with the CSC, the ghost tables and the edge values."""
    from gunrock_tpu_torch.parallel import partition
    g = gtt.io.rmat(scale=scale, edge_factor=16, seed=3, undirected=True)
    g.random_edge_values(seed=4)
    pg, perm = partition(g, 4, with_csc=True, with_ghosts=True,
                         with_edge_values=True, device=cuda)
    return g, pg, perm


@pytest.mark.cuda
@pytest.mark.parametrize("op,wmode", [("min", "add"), ("sum", "mul"),
                                      ("sum", "none")])
def test_pull_reduce2_compact_table_equals_plain(cuda, op, wmode):
    """K3 over a shard's compact table (S + p * ghost_cap values, S
    rows): ``min`` bitwise, sums within rtol 1e-5 of the float64-summing
    plain version, bitwise over two launches, one launch a call."""
    from gunrock_tpu_torch.ops.pull2 import pull_reduce2, pull_reduce2_plain
    from gunrock_tpu_torch.parallel.blocked import blocked_from_partition
    _, pg, _ = _sharded_graph(cuda)
    blk = blocked_from_partition(pg, compact=True, edge_weight="csc")
    assert blk.src_pad > blk.dst_pad
    gen = torch.Generator(device=cuda).manual_seed(1)
    for view in blk.views:
        table = torch.rand(view.n_values, device=cuda, generator=gen)
        before = K.LAUNCHES["pull_reduce2"]
        got = pull_reduce2(table, view, op=op, wmode=wmode)
        again = pull_reduce2(table, view, op=op, wmode=wmode)
        want = pull_reduce2_plain(table, view, op=op, wmode=wmode)
        torch.cuda.synchronize()
        assert K.LAUNCHES["pull_reduce2"] == before + 2
        assert torch.equal(got, again)
        if op == "min":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_pull_reached_words_on_a_shard_view_equals_plain(cuda):
    """K1 over each shard's global view, the gathered frontier words of
    every shard, at three densities: exact, one launch a shard."""
    from gunrock_tpu_torch.parallel.blocked import blocked_from_partition
    _, pg, _ = _sharded_graph(cuda)
    blk = blocked_from_partition(pg)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for density in (0.001, 0.1, 1.0):
        words = K.pack_bitmask(torch.rand(pg.v_global_pad, device=cuda,
                                          generator=gen) < density)
        for view in blk.views:
            before = K.LAUNCHES["pull_reached_words"]
            got = K.pull_reached_words(words, view)
            torch.cuda.synchronize()
            assert K.LAUNCHES["pull_reached_words"] == before + 1
            assert torch.equal(got, K.pull_reached_words_plain(words, view))


@pytest.mark.cuda
def test_sharded_bfs_sssp_pagerank_on_cuda_equal_single_card(cuda):
    """Sharded DO-BFS (K1 a shard), SSSP near-far with the pull-relax
    (K3 min) and PageRank (K3 sum) on 4 shards of the card, against the
    single-card port: labels and distances equal, ranks within the
    single-card tests' rtol 1e-4, atol 2e-7; K1 and K3 launched."""
    from gunrock_tpu_torch.parallel import (bfs_sharded, pagerank_sharded,
                                            sssp_sharded)
    g, _, _ = _sharded_graph(cuda)
    src = g.largest_degree_vertex()
    K.reset_launch_counts()
    sb = bfs_sharded(g, src, num_shards=4, direction_optimized=True,
                     mark_preds=True)
    assert K.LAUNCHES["pull_reached_words"] >= 4
    assert sb.info["blocked_kernels"] and sb.info["pull_iterations"] >= 1
    one = gtt.bfs(g, src, direction_optimized=True, device="cuda")
    assert np.array_equal(sb.labels, one.labels)
    K.reset_launch_counts()
    ss = sssp_sharded(g, src, num_shards=4, mode="nearfar", pull_frac=4)
    assert K.LAUNCHES["pull_reduce2"] >= 4
    one = gtt.sssp(g, src, mode="nearfar", device="cuda")
    assert np.array_equal(ss.distances, one.distances)
    K.reset_launch_counts()
    sp = pagerank_sharded(g, num_shards=4)
    assert K.LAUNCHES["pull_reduce2"] == 4 * sp.info["num_iterations"]
    one = gtt.pagerank(g, device="cuda")
    np.testing.assert_allclose(sp.ranks, one.ranks, rtol=1e-4, atol=2e-7)
    with pytest.raises(NotImplementedError):
        from gunrock_tpu_torch.parallel import make_mesh
        make_mesh(device=["cuda:0", "cpu"])


def _csc_view(offsets, indices, weights, n_values):
    """K3's graph fields over a CSC built on the card (no upload)."""
    from gunrock_tpu_torch.parallel.blocked import ShardView
    e = indices.shape[0]
    return ShardView(csc_offsets=offsets, csc_indices=indices,
                     csc_edge_values=weights, num_edges=e,
                     v_pad=offsets.shape[0] - 1, e_pad=e, n_values=n_values)


@pytest.mark.cuda
@pytest.mark.parametrize("op, wmode", [("sum", "none"), ("min", "add")])
def test_pull_reduce2_past_2_31_edges_equals_plain_in_chunks(cuda, op,
                                                             wmode):
    """K3's int64 instance over the circulant C(2^16; 1..2^14) (2^31
    edges, int64 offsets) against its plain version in row chunks of
    2^26 edges: min bitwise, sums within rtol 1e-5, atol 1e-6. About 16
    GiB on the card (indices and weights)."""
    from gunrock_tpu_torch.ops import pull2 as P
    n, h = 1 << 16, 1 << 14
    pattern = torch.cat([torch.arange(-h, 0), torch.arange(1, h + 1)]).to(
        cuda, torch.int32)
    idx = torch.empty(n * 2 * h, dtype=torch.int32, device=cuda)
    rows = idx.view(n, 2 * h)
    for r0 in range(0, n, 2048):
        v = torch.arange(r0, r0 + 2048, device=cuda, dtype=torch.int32)
        rows[r0:r0 + 2048] = (v[:, None] + pattern[None, :]) & (n - 1)
    offsets = torch.arange(n + 1, device=cuda, dtype=torch.int64) * (2 * h)
    gen = torch.Generator(device=cuda).manual_seed(31)
    w = None
    if wmode == "add":
        w = torch.randint(1, 65, (idx.shape[0],), device=cuda,
                          generator=gen).float()
    vals = torch.rand(n, device=cuda, generator=gen)
    view = _csc_view(offsets, idx, w, n)
    assert view.num_edges == 2**31
    before = K.LAUNCHES["pull_reduce2"]
    got = P.pull_reduce2(vals, view, op=op, wmode=wmode)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pull_reduce2"] == before + 1
    for r0 in range(0, n, 2048):
        e0, e1 = r0 * 2 * h, (r0 + 2048) * 2 * h
        chunk = _csc_view(offsets[r0:r0 + 2049] - e0, idx[e0:e1],
                          None if w is None else w[e0:e1], n)
        want = P.pull_reduce2_plain(vals, chunk, op=op, wmode=wmode)
        if op == "min":
            assert torch.equal(got[r0:r0 + 2048], want)
        else:
            torch.testing.assert_close(got[r0:r0 + 2048], want, rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("op, wmode", [("sum", "none"), ("sum", "mul"),
                                       ("min", "add")])
def test_pull_reduce2_int64_instance_equals_int32_at_flagship_size(
        cuda, op, wmode):
    """K3's int64 instance against its int32 one on a random CSC of the
    flagship's size (2^20 rows, 2^25 edges, hub rows past a tile): the
    same offsets in both widths give the same bits."""
    from gunrock_tpu_torch.ops import pull2 as P
    gen = torch.Generator(device=cuda).manual_seed(20)
    n = 1 << 20
    deg = torch.randint(0, 63, (n,), device=cuda, generator=gen)
    deg[torch.randint(0, n, (64,), device=cuda, generator=gen)] = 20000
    off = torch.zeros(n + 1, dtype=torch.int64, device=cuda)
    torch.cumsum(deg, 0, out=off[1:])
    e = int(off[-1])
    idx = torch.randint(0, n, (e,), device=cuda, generator=gen,
                        dtype=torch.int32)
    w = torch.rand(e, device=cuda, generator=gen)
    vals = torch.rand(n, device=cuda, generator=gen)
    wide = _csc_view(off, idx, w, n)
    narrow = _csc_view(off.to(torch.int32), idx, w, n)
    got = P.pull_reduce2(vals, wide, op=op, wmode=wmode)
    want = P.pull_reduce2(vals, narrow, op=op, wmode=wmode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_process_group_gloo_on_the_card_equals_single_card(cuda, tmp_path):
    """2 Gloo ranks sharing the card (``tools.shard_ranks``, the kernels
    built here first): sharded DO-BFS (K1 on each rank's shard), SSSP
    near-far with the pull-relax (K3 min) and PageRank (K3 sum) against
    the single card: labels and distances equal, ranks within rtol 1e-4,
    atol 2e-7; each rank launched its kernels."""
    from gunrock_tpu_torch.tools.shard_ranks import build_graph, launch
    spec_g = {"kind": "rmat", "scale": 14, "edge_factor": 16, "seed": 7,
              "undirected": True, "weights": 3}
    g = build_graph(spec_g)
    src = g.largest_degree_vertex()
    spec = {"graphs": {"g": spec_g}, "runs": [
        {"name": "bfs", "prim": "bfs", "graph": "g", "src": src,
         "kwargs": {"direction_optimized": True, "mark_preds": True}},
        {"name": "sssp", "prim": "sssp", "graph": "g", "src": src,
         "kwargs": {"mode": "nearfar", "pull_frac": 4}},
        {"name": "pagerank", "prim": "pagerank", "graph": "g",
         "kwargs": {}}]}
    records, arrays = launch(spec, str(tmp_path), world=2, backend="gloo",
                             device="cuda", deadline=300, build=True)
    for rec in records:
        runs = rec["runs"]
        assert runs["bfs"]["launches"].get("pull_reached_words", 0) >= 1
        assert runs["sssp"]["launches"].get("pull_reduce2", 0) >= 1
        assert runs["pagerank"]["launches"]["pull_reduce2"] == \
            runs["pagerank"]["info"]["num_iterations"]
        assert runs["bfs"]["info"]["backend"] == "gloo"
        assert runs["bfs"]["device"].startswith("cuda")
    one = gtt.bfs(g, src, direction_optimized=True, device="cuda")
    assert np.array_equal(arrays["bfs/labels"], one.labels)
    one = gtt.sssp(g, src, mode="nearfar", device="cuda")
    assert np.array_equal(arrays["sssp/distances"], one.distances)
    one = gtt.pagerank(g, device="cuda")
    np.testing.assert_allclose(arrays["pagerank/ranks"], one.ranks,
                               rtol=1e-4, atol=2e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("sizet64", [False, True])
@pytest.mark.parametrize("test", ["bfs", "sssp"])
@pytest.mark.parametrize("name", HIT_CASES)
def test_last_hit_rows_kernel_equals_plain(cuda, name, test, sizet64):
    """K14 bit for bit against its plain version on the tile cases (the
    R-MAT ones at scale 17: hub rows over hundreds of tiles), with BFS
    labels and with SSSP distances over weights of 0 and of 2^-26, on
    int32 and int64 offsets; two launches agree, one launch a call."""
    g = hit_graph(name, scale=17)
    dg = gtt.to_device(g, with_csc=True, with_edge_values=True,
                       sizet64=sizet64, device=cuda)
    assert (dg.csc_offsets.dtype == torch.int64) == sizet64
    root = int(torch.argmax(dg.row_offsets[1:] - dg.row_offsets[:-1]))
    if test == "bfs":
        vals, _, _ = gtt.models.bfs_device(dg, root)
        w = None
    else:
        vals, _, _ = gtt.models.sssp_device(dg, root)
        w = dg.csc_edge_values
    before = K.LAUNCHES["last_hit_rows"]
    got = K.last_hit_rows(dg, vals, w)
    again = K.last_hit_rows(dg, vals, w)
    torch.cuda.synchronize()
    assert K.LAUNCHES["last_hit_rows"] == before + 2
    want = K.last_hit_rows_plain(dg, vals, w)
    assert got.dtype == torch.int64 and got.shape == (dg.v_pad,)
    assert (want >= 0).any() and (want < 0).any()
    assert torch.equal(got, want) and torch.equal(again, got)
    with pytest.raises(ValueError, match="int32|float32"):
        K.last_hit_rows(dg, vals.double(), w)


@pytest.mark.cuda
def test_fills_on_cuda_equal_cpu_and_launch_k14(cuda):
    """DO-BFS and SSSP with preds on the card give the CPU run's preds,
    one K14 launch a call."""
    g = gtt.io.rmat(scale=14, edge_factor=16, seed=3, undirected=True)
    g.random_edge_values(seed=3)
    src = g.largest_degree_vertex()
    dg = gtt.to_device(g, with_csc=True, with_blocked_csc=True,
                       with_edge_values=True, device=cuda)
    for run in (lambda d: gtt.bfs(d, src, mark_preds=True,
                                  direction_optimized=True),
                lambda d: gtt.sssp(d, src, mark_preds=True)):
        want = run(gtt.to_device(g, with_csc=True, with_blocked_csc=True,
                                 with_edge_values=True, device="cpu"))
        before = K.LAUNCHES["last_hit_rows"]
        got = run(dg)
        assert K.LAUNCHES["last_hit_rows"] == before + 1
        np.testing.assert_array_equal(got.preds, want.preds)


@pytest.mark.cuda
def test_fill_kernel_lies_in_the_fill_span(cuda):
    """A traced DO-BFS: K14's launch lies inside the ``bfs.fill_preds``
    span, and no tile-rows prologue (``csc_tile_rows_kernel``, which the
    K1 and K3 roofline readers count) is launched there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gunrock_tpu_torch.enactor import tracing
    g = gtt.io.rmat(scale=14, edge_factor=16, seed=7, undirected=True)
    src = g.largest_degree_vertex()
    dg = gtt.to_device(g, with_csc=True, with_blocked_csc=True, device=cuda)
    gtt.bfs(dg, src, mark_preds=True, direction_optimized=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing() as spans:
            gtt.bfs(dg, src, mark_preds=True, direction_optimized=True)
    evs = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in evs
              if e.device_type() != DeviceType.CUDA
              and e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
    fills = [(s, e) for _, _, _, name, s, e, _ in spans
             if name == "bfs.fill_preds"]
    assert len(fills) == 1
    (s, e), = fills
    inside = [ev.name() for ev in evs if ev.device_type() == DeviceType.CUDA
              and s <= launch.get(ev.correlation_id(), -1) <= e]
    assert sum("last_hit_rows_kernel" in n for n in inside) == 1
    assert not any("csc_tile_rows_kernel" in n or "SegmentedReduce" in n
                   for n in inside)
