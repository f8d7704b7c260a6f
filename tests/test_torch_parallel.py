"""The sharded zoo of the PyTorch port (``gunrock_tpu_torch.parallel``)
against the JAX package's (``gunrock_tpu.parallel``), on the CPU.

The JAX package runs on the 8 virtual CPU devices of
``tests/conftest.py``; the port runs its shards stacked on the CPU
(``make_mesh(p, device="cpu")``). Both build each graph from one seed
with byte-identical host generators, and both partitions come from the
same numpy generators, so the tests hold, exactly:

  * every partition method's ``perm`` and stacked arrays, bit for bit;
  * BFS (non-DO, DO, and DO through the shard views, against the JAX
    package's ``use_blocked=True, pallas_interpret=True``): labels,
    predecessors (push winners by the receive order, pull ones by the
    first frontier in-edge) and every ``info`` field the JAX record
    carries: ``num_iterations``, ``direction_trace``,
    ``pull_iterations``, ``comm_bytes``, ``search_depth``;
  * SSSP (bellman, near-far, the pull-relax at ``pull_frac=2``):
    distances bitwise (the float32 fixpoint of min(d[u] + w) is one),
    iterations and ``comm_bytes``;
  * CC components, TopK ids and values, TC counts, ``bfs_batch`` labels.

Float sums differ in order: the JAX package differences a float32
running sum over all edges (``row_reduce_sorted``), the port sums each
row in float64 (and K3's plain version likewise). So, with the
single-card tests' tolerances: PageRank rtol 1e-4, atol 2e-7
(``tests/test_torch_pr.py``) and equal iterations on undirected graphs;
BC rtol 1e-4, atol 1e-4 and sigma rtol 1e-5 (``tests/test_torch_bc.py``);
HITS rtol 1e-4, atol 2e-5, SALSA rtol 1e-4, atol 1e-6
(``tests/test_torch_pr.py``); WTF's PPR rtol 1e-4, atol 1e-7, its
scores within rtol 1e-5, atol 1e-9 of the float64 oracle ``cpu_wtf``
and of the JAX package's by that package's own distance from the oracle
(its float32 running sums stray up to 3e-4 relative), and the circle of
trust and ranking by
``tests/test_torch_wtf.py``'s rule (the CoT held exactly, on graphs
where V <= 1000 or the float64 gap at the cut passes 1e-6; ids where
the scores stand apart).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu.parallel as JP
import gunrock_tpu_torch as gtt
import gunrock_tpu_torch.parallel as TP
from gunrock_tpu_torch import cli
from gunrock_tpu_torch.ops import kernels as K
from gunrock_tpu_torch.ops.pull2 import pull_reduce2, pull_reduce2_plain
from gunrock_tpu_torch.parallel.blocked import blocked_from_partition

PR_TOL = dict(rtol=1e-4, atol=2e-7)
BC_TOL = dict(rtol=1e-4, atol=1e-4)
SIGMA_TOL = dict(rtol=1e-5)
LINK_TOL = {"hits": dict(rtol=1e-4, atol=2e-5),
            "salsa": dict(rtol=1e-4, atol=1e-6)}
PPR_TOL = dict(rtol=1e-4, atol=1e-7)
SCORE_TOL = dict(rtol=1e-4, atol=1e-9)
SCORE64_TOL = dict(rtol=1e-5, atol=1e-9)  # WTF's scores, float64 oracle
ORACLE_TOL = dict(rtol=1e-3, atol=1e-6)  # the CLI's check of WTF

_CACHE = {}


def _once(key, fn):
    """Build a JAX result (or graph pair) once per module."""
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _rmat(scale=10, edge_factor=8, seed=42, weights=None, undirected=True):
    def build():
        pair = tuple(m.io.rmat(scale=scale, edge_factor=edge_factor,
                               seed=seed, undirected=undirected)
                     for m in (gt, gtt))
        if weights is not None:
            for g in pair:
                g.random_edge_values(seed=weights)
        return pair
    return _once(("rmat", scale, edge_factor, seed, weights, undirected),
                 build)


def _grid(n=32, weights=None):
    def build():
        idx = np.arange(n * n).reshape(n, n)
        src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
        dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
        pair = tuple(m.from_coo(n * n, src, dst, undirected=True)
                     for m in (gt, gtt))
        if weights is not None:
            for g in pair:
                g.random_edge_values(seed=weights)
        return pair
    return _once(("grid", n, weights), build)


def _mesh(p):
    return TP.make_mesh(p, device="cpu")


# ---- the mesh --------------------------------------------------------

def test_make_mesh_shards_on_one_device():
    m = TP.make_mesh(4, device="cpu")
    assert (m.num_shards, m.device.type, m.axis) == (4, "cpu", TP.AXIS)
    assert TP.make_mesh(device="cpu").num_shards == 1
    # the reference's --device=0,0: one device listed per shard
    assert TP.make_mesh(device=["cpu", "cpu", "cpu"]).num_shards == 3
    with pytest.raises(NotImplementedError):
        TP.make_mesh(device=["cpu", "meta"])
    with pytest.raises(ValueError):
        TP.make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.bfs_sharded(_rmat(8)[1], 0, num_shards=2)


def test_parallel_exports_every_jax_name():
    want = {n for n in dir(JP) if not n.startswith("_")
            and not isinstance(getattr(JP, n), type(JP))}
    assert want <= set(dir(TP)), sorted(want - set(dir(TP)))


# ---- partitioning ----------------------------------------------------

def _fields(tpg):
    """A port partition's fields as numpy arrays and ints."""
    return {f.name: (getattr(tpg, f.name).cpu().numpy()
                     if torch.is_tensor(getattr(tpg, f.name))
                     else getattr(tpg, f.name))
            for f in dataclasses.fields(tpg)}


def _assert_same_partition(jpg, tpg):
    for name, val in _fields(tpg).items():
        if name == "shard_lo":
            # the port's one extra field: a JAX partition holds every
            # shard
            assert val == 0
            continue
        want = getattr(jpg, name)
        if val is None or want is None:
            assert val is None and want is None, name
        elif isinstance(val, np.ndarray):
            want = np.asarray(want)
            assert want.dtype == val.dtype and want.shape == val.shape, name
            assert np.array_equal(want, val), name
        else:
            assert val == want, name


@pytest.mark.parametrize("method,p", [
    (m, p) for m in ("static", "random", "biasrandom", "cluster", "metis",
                     "lp", "duplicate") for p in (2, 4)] + [("random", 8)])
def test_partition_equals_jax(method, p):
    gj, gp = _rmat(9, weights=1)
    kw = dict(method=method, seed=3, with_csc=True, with_ghosts=True,
              with_edge_values=True)
    jpg, jperm = JP.partition(gj, p, **kw)
    tpg, tperm = TP.partition(gp, p, device="cpu", **kw)
    assert np.array_equal(jperm, tperm)
    _assert_same_partition(jpg, tpg)


@pytest.mark.parametrize("flags", [{}, {"with_csc": True},
                                   {"with_edge_values": True}])
def test_partition_flags_equal_jax_on_the_grid(flags):
    gj, gp = _grid(24)
    jpg, jperm = JP.partition(gj, 4, method="cluster", **flags)
    tpg, tperm = TP.partition(gp, 4, method="cluster", device="cpu", **flags)
    assert np.array_equal(jperm, tperm)
    _assert_same_partition(jpg, tpg)


def test_from_numpy_roundtrips_a_jax_partition():
    gj, _ = _rmat(9, weights=1)
    jpg, _ = JP.partition(gj, 4, with_csc=True, with_ghosts=True,
                          with_edge_values=True)
    fields = {f: getattr(jpg, f) for f in (
        "num_nodes", "num_edges", "num_shards", "shard_size", "e_shard_pad",
        "ghost_cap", "fwd_ghost_cap")}
    fields.update({f: None if getattr(jpg, f) is None
                   else np.asarray(getattr(jpg, f))
                   for f in ("row_offsets", "col_indices", "edge_values",
                             "csc_offsets", "csc_indices", "csc_edge_values",
                             "csc_local", "ghost_send_idx", "col_local",
                             "fwd_ghost_send_idx")})
    tpg = TP.PartitionedGraph.from_numpy(fields, "cpu")
    _assert_same_partition(jpg, tpg)
    again = TP.PartitionedGraph.from_numpy(_fields(tpg), "cpu")
    _assert_same_partition(jpg, again)
    assert tpg.v_global_pad == jpg.v_global_pad and tpg.has_ghosts


def test_boundary_fraction_and_label_propagation_equal_jax():
    gj, gp = _rmat(10)
    for seed in (0, 1):
        lj = JP.label_propagation(gj, 8, seed=seed)
        lt = TP.label_propagation(gp, 8, seed=seed)
        assert np.array_equal(lj, lt)
        assert JP.boundary_fraction(gj, lj) == TP.boundary_fraction(gp, lt)
    for method in ("random", "metis"):
        j, _ = JP.make_permutation(gj, method, 4, 2)
        t, _ = TP.make_permutation(gp, method, 4, 2)
        assert np.array_equal(j, t)


# ---- the boundary exchange ------------------------------------------

@pytest.mark.parametrize("cap", [1, 3, 40, 128])
def test_bucket_by_owner_equals_jax(cap):
    """One shard's buckets, with the drop slot past each peer's cap
    (overflow below 40 lanes a peer)."""
    import jax.numpy as jnp
    from gunrock_tpu.parallel.comm import bucket_by_owner as jbucket
    rng = np.random.default_rng(cap)
    p, n = 4, 300
    owner = rng.integers(0, p, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    pay = [rng.integers(0, 10**6, n).astype(np.int32),
           rng.random(n).astype(np.float32)]
    jb, jc, jo = jbucket(jnp.asarray(owner), jnp.asarray(mask),
                         [jnp.asarray(x) for x in pay], num_shards=p,
                         per_peer_cap=cap)
    tb, tc, to = TP.bucket_by_owner(
        torch.from_numpy(owner), torch.from_numpy(mask),
        [torch.from_numpy(x) for x in pay], num_shards=p, per_peer_cap=cap)
    assert bool(jo) == to == (cap < 100)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    for a, b in zip(jb, tb):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_exchange_and_ghost_exchange_equal_jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from gunrock_tpu.parallel.comm import exchange as jexchange
    from gunrock_tpu.parallel.comm import ghost_exchange as jghost
    p = 4
    mesh = Mesh(np.array(jax.devices()[:p]), (JP.AXIS,))
    rng = np.random.default_rng(5)
    bufs = rng.integers(0, 1000, (p, p, 16)).astype(np.int32)
    counts = rng.integers(0, 17, (p, p)).astype(np.int32)

    def jfn(b, c):
        (rb,), rc = jexchange(JP.AXIS, [b.reshape(p, 16)], c.reshape(p))
        return rb[None], rc[None]
    rb, rc = jax.shard_map(jfn, mesh=mesh, in_specs=(P(JP.AXIS), P(JP.AXIS)),
                           out_specs=(P(JP.AXIS), P(JP.AXIS)))(
        jnp.asarray(bufs), jnp.asarray(counts))
    (tb,), tc = TP.exchange([torch.from_numpy(bufs)],
                            torch.from_numpy(counts))
    assert np.array_equal(np.asarray(rb), tb.numpy())
    assert np.array_equal(np.asarray(rc), tc.numpy())
    mask = TP.recv_mask(torch.from_numpy(counts), 16)
    assert np.array_equal(np.asarray(JP.recv_mask(jnp.asarray(counts[1]),
                                                  16)), mask[1].numpy())
    # ghost exchange over a real partition's tables
    gj, gp = _rmat(9)
    jpg, _ = JP.partition(gj, p, with_csc=True, with_ghosts=True)
    tpg, _ = TP.partition(gp, p, with_csc=True, with_ghosts=True,
                          device="cpu")
    vals = rng.random((p, jpg.shard_size)).astype(np.float32)
    G = jpg.ghost_cap

    def gfn(v, s):
        return jghost(JP.AXIS, v.reshape(-1), s.reshape(p, G))[None]
    jt = jax.shard_map(gfn, mesh=mesh, in_specs=(P(JP.AXIS), P(JP.AXIS)),
                       out_specs=P(JP.AXIS))(jnp.asarray(vals),
                                             jpg.ghost_send_idx)
    tt = TP.ghost_exchange(torch.from_numpy(vals), tpg.ghost_send_idx)
    assert np.array_equal(np.asarray(jt), tt.numpy())


def test_shard_views_and_compact_k3_plain():
    """The views K1 and K3 read: global and compact table spaces, each
    view's real edge count; K3's plain version over a compact table (a
    table longer than the rows) against a numpy pull."""
    gj, gp = _rmat(9, weights=2)
    pg, _ = TP.partition(gp, 4, with_csc=True, with_ghosts=True,
                         with_edge_values=True, device="cpu")
    S, G = pg.shard_size, pg.ghost_cap
    glob = blocked_from_partition(pg)
    comp = blocked_from_partition(pg, compact=True, edge_weight="csc")
    assert (glob.src_pad, glob.dst_pad) == (4 * S, S)
    assert comp.src_pad == S + 4 * G and comp.num_shards == 4
    rng = np.random.default_rng(0)
    for i, view in enumerate(comp.views):
        assert view.num_edges == int(pg.csc_offsets[i, -1])
        assert view.n_values == S + 4 * G and view.v_pad == S
        table = torch.from_numpy(rng.random(view.n_values).astype(
            np.float32))
        off = pg.csc_offsets[i].numpy().astype(np.int64)
        ids = pg.csc_local[i].numpy()
        w = pg.csc_edge_values[i].numpy()
        for op in ("min", "sum"):
            got = pull_reduce2(table, view, op=op, wmode="add")
            assert torch.equal(got, pull_reduce2_plain(table, view, op=op,
                                                       wmode="add"))
            vals = table.numpy()[ids].astype(np.float64) + w
            want = np.array([
                (vals[a:b].min() if op == "min" else vals[a:b].sum())
                if b > a else (np.inf if op == "min" else 0.0)
                for a, b in zip(off[:-1], off[1:])], np.float32)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        with pytest.raises(ValueError, match="shape"):
            pull_reduce2(table[:S], view, op="min", wmode="add")
    words = K.pack_bitmask(torch.from_numpy(rng.random(4 * S) < 0.1))
    reached = torch.cat([K.unpack_bitmask(K.pull_reached_words(words, v), S)
                         for v in glob.views])
    hit = K.unpack_bitmask(words, 4 * S)
    src = pg.csc_indices.long()
    for i in range(4):
        off = pg.csc_offsets[i].long()
        want = [bool(hit[src[i, a:b]].any()) for a, b in
                zip(off[:-1].tolist(), off[1:].tolist())]
        assert reached[i * S:(i + 1) * S].tolist() == want


# ---- BFS ---------------------------------------------------------------

BFS_INFO = ("num_iterations", "direction_trace", "pull_iterations",
            "comm_bytes", "search_depth", "frontier_overflow",
            "blocked_kernels", "num_shards", "edges_visited")
BFS_MODES = {"push": dict(direction_optimized=False),
             "do": dict(direction_optimized=True, use_blocked=False),
             "do_views": dict(direction_optimized=True, use_blocked=True)}


def _bfs_pair(graph, p, mode, **kw):
    gj, gp = graph
    opts = dict(BFS_MODES[mode], **kw)
    key = ("bfs", id(gj), p, mode, tuple(sorted(kw.items())))
    jkw = dict(opts, pallas_interpret=opts.get("use_blocked", False))
    want = _once(key, lambda: JP.bfs_sharded(gj, num_shards=p, **jkw))
    got = TP.bfs_sharded(gp, num_shards=p, device="cpu", **opts)
    return want, got


def _assert_bfs_equal(want, got, preds=True):
    assert np.array_equal(want.labels, got.labels)
    if preds:
        assert np.array_equal(want.preds, got.preds)
    for key in BFS_INFO:
        assert got.info[key] == want.info[key], key


@pytest.mark.parametrize("mode", list(BFS_MODES))
@pytest.mark.parametrize("p", [2, 4])
def test_bfs_sharded_equals_jax(p, mode):
    want, got = _bfs_pair(_rmat(), p, mode, src=3, seed=3, mark_preds=True)
    _assert_bfs_equal(want, got)
    if mode != "push":
        assert got.info["pull_iterations"] >= 1


@pytest.mark.parametrize("mode", list(BFS_MODES))
def test_bfs_sharded_equals_jax_on_8_shards(mode):
    want, got = _bfs_pair(_rmat(), 8, mode, src=2, mark_preds=True,
                          partition_method="biasrandom")
    _assert_bfs_equal(want, got)


@pytest.mark.parametrize("mode", ["push", "do"])
def test_bfs_sharded_equals_jax_on_the_grid(mode):
    want, got = _bfs_pair(_grid(), 4, mode, src=0, mark_preds=True,
                          partition_method="cluster")
    _assert_bfs_equal(want, got)
    assert got.info["search_depth"] == 62


@pytest.mark.parametrize("mode", ["push", "do"])
@pytest.mark.parametrize("sizing", [0.01, 0.05])
def test_bfs_sharded_overflow_retries_equal_jax(sizing, mode):
    """Queues, out-lanes and per-peer buffers too small: both packages
    retry with doubled sizing and end at the same run."""
    want, got = _bfs_pair(_rmat(), 4, mode, src=0, mark_preds=True,
                          queue_sizing=sizing, in_sizing=sizing)
    _assert_bfs_equal(want, got)
    assert not got.info["frontier_overflow"]


def test_bfs_sharded_device_on_one_partition():
    """Both ``bfs_sharded_device`` functions on the one JAX partition
    (carried across by ``from_numpy``), overflowing at a small sizing:
    labels, predecessors, iterations, overflow, bytes and the trace."""
    import jax
    from gunrock_tpu.parallel.bfs import bfs_sharded_device as jdev
    gj, _ = _rmat()
    jpg, perm = JP.partition(gj, 4, seed=1, with_csc=True)
    tpg = TP.PartitionedGraph.from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in vars(jpg).items()}, "cpu")
    src = int(perm[7])
    for kw in (dict(direction_optimized=True, mark_preds=True),
               dict(mark_preds=True, queue_sizing=0.05, in_sizing=0.05),
               dict(direction_optimized=True, queue_sizing=0.02)):
        want = jax.block_until_ready(jdev(jpg, src, **kw))
        got = TP.bfs_sharded_device(tpg, src, **kw)
        assert np.array_equal(np.asarray(want[0]), got[0].numpy())
        if kw.get("mark_preds"):
            assert np.array_equal(np.asarray(want[1]), got[1].numpy())
        assert int(want[2]) == got[2] and bool(want[4]) == got[4]
        assert float(want[5]) == float(got[5])
        assert np.array_equal(np.asarray(want[6]), got[6])


def test_bfs_sharded_comm_latency_knob():
    gj, gp = _rmat()
    base = TP.bfs_sharded(gp, 0, num_shards=4, direction_optimized=True,
                          device="cpu")
    slow = TP.bfs_sharded(gp, 0, num_shards=4, direction_optimized=True,
                          comm_latency=50, device="cpu")
    assert np.array_equal(slow.labels, base.labels)
    assert slow.info["comm_latency_rounds"] == 50
    assert base.info["comm_bytes"] > 0


# ---- SSSP --------------------------------------------------------------

SSSP_MODES = {"bellman": dict(mode="bellman", use_blocked=False),
              "nearfar": dict(mode="nearfar", use_blocked=False),
              "pull": dict(mode="bellman", use_blocked=True, pull_frac=2),
              "nearfar_pull": dict(mode="nearfar", use_blocked=True,
                                   pull_frac=2)}


def _sssp_pair(graph, p, mode, **kw):
    gj, gp = graph
    opts = dict(SSSP_MODES[mode], **kw)
    key = ("sssp", id(gj), p, mode, tuple(sorted(kw.items())))
    want = _once(key, lambda: JP.sssp_sharded(
        gj, num_shards=p, pallas_interpret=opts["use_blocked"], **opts))
    return want, TP.sssp_sharded(gp, num_shards=p, device="cpu", **opts)


def _assert_sssp_equal(want, got):
    assert np.array_equal(want.distances, got.distances)
    for key in ("num_iterations", "comm_bytes", "frontier_overflow",
                "delta", "edges_visited", "blocked_kernels"):
        assert got.info[key] == want.info[key], key


@pytest.mark.parametrize("mode", list(SSSP_MODES))
@pytest.mark.parametrize("p", [2, 4])
def test_sssp_sharded_equals_jax(p, mode):
    want, got = _sssp_pair(_rmat(9, weights=2), p, mode, src=0, seed=1)
    _assert_sssp_equal(want, got)


def test_sssp_sharded_nearfar_pull_on_the_grid():
    want, got = _sssp_pair(_grid(weights=3), 4, "nearfar_pull", src=0)
    _assert_sssp_equal(want, got)


def test_sssp_sharded_overflow_retries_equal_jax():
    want, got = _sssp_pair(_rmat(9, weights=2), 4, "bellman", src=0,
                           queue_sizing=0.02, in_sizing=0.02)
    _assert_sssp_equal(want, got)
    assert not got.info["frontier_overflow"]


def test_sssp_sharded_device_on_one_partition():
    import jax
    from gunrock_tpu.parallel.sssp import sssp_sharded_device as jdev
    gj, _ = _rmat(9, weights=2)
    jpg, perm = JP.partition(gj, 4, with_edge_values=True, with_csc=True,
                             with_ghosts=True)
    from gunrock_tpu.parallel.blocked import blocked_from_partition as jblk
    tpg = TP.PartitionedGraph.from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in vars(jpg).items()}, "cpu")
    jb = jblk(jpg, compact=True, with_vertex_samples=True, edge_weight="csc")
    tb = blocked_from_partition(tpg, compact=True, edge_weight="csc")
    for kw in (dict(mode="nearfar", delta=40.0), dict(pull_frac=2),
               dict(queue_sizing=0.02)):
        blk = "pull_frac" in kw
        want = jax.block_until_ready(jdev(
            jpg, int(perm[3]), blocked=jb if blk else None,
            pallas_interpret=blk, **kw))
        got = TP.sssp_sharded_device(tpg, int(perm[3]),
                                     blocked=tb if blk else None, **kw)
        assert np.array_equal(np.asarray(want[0]), got[0].numpy())
        assert int(want[1]) == got[1] and bool(want[2]) == got[2]
        assert float(want[3]) == float(got[3])


# ---- PageRank, CC, BC, HITS, SALSA, WTF -------------------------------

@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_pagerank_sharded_equals_jax(p, blocked):
    gj, gp = _rmat()
    want = _once(("pr", p, blocked), lambda: JP.pagerank_sharded(
        gj, num_shards=p, use_blocked=blocked, pallas_interpret=blocked))
    got = TP.pagerank_sharded(gp, num_shards=p, use_blocked=blocked,
                              device="cpu")
    np.testing.assert_allclose(got.ranks, want.ranks, **PR_TOL)
    for key in ("num_iterations", "comm_bytes", "ghost_cap",
                "blocked_kernels"):
        assert got.info[key] == want.info[key], key


@pytest.mark.parametrize("graph,p", [("rmat", 2), ("rmat", 4), ("grid", 4),
                                     ("rmat", 8)])
def test_cc_sharded_equals_jax(graph, p):
    gj, gp = _rmat() if graph == "rmat" else _grid()
    want = _once(("cc", graph, p), lambda: JP.cc_sharded(gj, num_shards=p))
    got = TP.cc_sharded(gp, num_shards=p, device="cpu")
    assert np.array_equal(got.components, want.components)
    for key in ("num_components", "num_iterations", "ghost_cap"):
        assert got.info[key] == want.info[key], key


def test_cc_sharded_disconnected_equals_jax():
    src = np.array([0, 1, 2, 4, 5, 6])
    dst = np.array([1, 2, 0, 5, 6, 4])
    want = JP.cc_sharded(gt.from_coo(8, src, dst, undirected=True),
                         num_shards=2)
    got = TP.cc_sharded(gtt.from_coo(8, src, dst, undirected=True),
                        num_shards=2, device="cpu")
    assert got.num_components == want.num_components == 4
    assert np.array_equal(got.components, want.components)


@pytest.mark.parametrize("p", [2, 4])
def test_bc_sharded_equals_jax(p):
    gj, gp = _rmat()
    want = _once(("bc", p), lambda: JP.bc_sharded(gj, src="largestdegree",
                                                  num_shards=p))
    got = TP.bc_sharded(gp, src="largestdegree", num_shards=p, device="cpu")
    assert np.array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.sigmas, want.sigmas, **SIGMA_TOL)
    np.testing.assert_allclose(got.bc_values, want.bc_values, **BC_TOL)
    assert got.info["search_depth"] == want.info["search_depth"]


@pytest.mark.parametrize("kind", ["hits", "salsa"])
@pytest.mark.parametrize("p", [2, 4])
def test_link_analysis_sharded_equals_jax(kind, p):
    gj, gp = _rmat()
    want = _once((kind, p), lambda: getattr(JP, f"{kind}_sharded")(
        gj, num_shards=p, max_iters=10))
    got = getattr(TP, f"{kind}_sharded")(gp, num_shards=p, max_iters=10,
                                         device="cpu")
    np.testing.assert_allclose(got.hubs, want.hubs, **LINK_TOL[kind])
    np.testing.assert_allclose(got.auths, want.auths, **LINK_TOL[kind])
    assert got.info["comm_bytes"] == want.info["comm_bytes"]


def _apart(scores, rtol=SCORE_TOL["rtol"], atol=SCORE_TOL["atol"]):
    """Ranks whose score differs from both neighbours' by more than the
    score tolerance: there the order cannot depend on rounding."""
    s = np.asarray(scores, np.float64)
    gap = np.full(s.shape[0] + 1, np.inf)
    gap[1:-1] = np.abs(np.diff(s))
    return np.minimum(gap[:-1], gap[1:]) > atol + rtol * np.abs(s)


# (undirected, scale, seed) of tests/test_torch_wtf.py: V = 256, where
# the CoT is every vertex, and the directed V = 2048 graph whose float64
# PPR from vertex 0 has a gap above 1e-6 at rank 1000 (asserted), where
# the CoT is held exactly too.
@pytest.mark.parametrize("graph,p", [((True, 8, 8), 2), ((True, 8, 8), 4),
                                     ((False, 11, 34), 4)])
def test_wtf_sharded_equals_jax(graph, p):
    """PPR within ``PPR_TOL``; the circle of trust and the ranking by the
    rule of ``tests/test_torch_wtf.py``; the scores against ``cpu_wtf``
    at the CLI's tolerance."""
    from gunrock_tpu_torch.utils.reference import cpu_wtf
    undirected, scale, seed = graph
    gj, gp = _rmat(scale, seed=seed, undirected=undirected)
    src = 0
    want = _once(("wtf", graph, p), lambda: JP.wtf_sharded(
        gj, src=src, max_iters=10, threshold=0.0, num_shards=p))
    got = TP.wtf_sharded(gp, src=src, max_iters=10, threshold=0.0,
                         num_shards=p, device="cpu")
    assert got.info["ppr_iterations"] == want.info["ppr_iterations"] == 10
    np.testing.assert_allclose(got.ppr_ranks, want.ppr_ranks, **PPR_TOL)
    n, cap = gp.num_nodes, min(1000, gp.num_nodes)
    ref, ppr64 = cpu_wtf(gp, src, max_iters=10, threshold=0.0)
    s64 = np.sort(ppr64)[::-1]
    cot = np.argsort(-got.ppr_ranks, kind="stable")[:cap]
    jcot = np.argsort(-want.ppr_ranks, kind="stable")[:cap]
    assert n <= 1000 or s64[cap - 1] - s64[cap] > 1e-6
    assert set(cot.tolist()) == set(jcot.tolist())
    # The scores: the port's within SCORE64_TOL of the float64 oracle;
    # the JAX package's float32 running sums stray further (up to 3e-4
    # relative on the directed graph), so each JAX score is held to the
    # port's within its own distance from the oracle plus SCORE64_TOL.
    np.testing.assert_allclose(got.scores, ref[got.node_ids],
                               **SCORE64_TOL)
    np.testing.assert_allclose(want.scores, ref[want.node_ids],
                               **ORACLE_TOL)
    ids, gi, wi = np.intersect1d(got.node_ids, want.node_ids,
                                 return_indices=True)
    assert ids.shape[0] >= 0.99 * cap
    g_s, w_s = got.scores[gi].astype(np.float64), want.scores[wi]
    assert (np.abs(g_s - w_s) <= np.abs(w_s - ref[ids])
            + SCORE64_TOL["atol"] + SCORE64_TOL["rtol"] * np.abs(w_s)).all()
    keep = _apart(got.scores) & _apart(want.scores)
    assert keep.sum() > 10
    assert np.array_equal(got.node_ids[keep], want.node_ids[keep])


@pytest.mark.parametrize("p", [2, 4, 8])
def test_topk_sharded_equals_jax(p):
    gj, gp = _rmat()
    want = JP.topk_sharded(gj, k=16, num_shards=p, seed=p)
    got = TP.topk_sharded(gp, k=16, num_shards=p, seed=p, device="cpu")
    assert np.array_equal(got.node_ids, want.node_ids)
    assert np.array_equal(got.centralities, want.centralities)


@pytest.mark.parametrize("p", [2, 8])
def test_tc_sharded_equals_jax(p, monkeypatch):
    """Several chunks (a small wedge budget, set for both packages) over
    the shards."""
    monkeypatch.setenv("GUNROCK_TC_WEDGE_BUDGET", "4096")
    gj, gp = _rmat(9)
    want = JP.tc_sharded(gj, num_shards=p)
    got = TP.tc_sharded(gp, num_shards=p, device="cpu")
    assert got.total == want.total
    assert np.array_equal(got.vertex_counts, want.vertex_counts)
    for key in ("num_chunks", "chunks_per_shard", "wedges_probed"):
        assert got.info[key] == want.info[key], key
    assert got.info["num_chunks"] > 2


def test_bfs_batch_and_bc_batch_equal_jax():
    import jax
    from jax.sharding import Mesh
    gj, gp = _rmat()
    jmesh = Mesh(np.array(jax.devices()[:4]), (JP.AXIS,))
    sources = [0, 3, 7, 11, 19]
    want = JP.bfs_batch(gj, sources, mesh=jmesh)
    got = TP.bfs_batch(gp, sources, mesh=_mesh(4))
    assert np.array_equal(got.labels, want.labels)
    assert got.info["num_sources"] == 5 and got.info["num_shards"] == 4
    want = JP.bc_batch(gj, [0, 5, 9], mesh=jmesh)
    got = TP.bc_batch(gp, [0, 5, 9], mesh=_mesh(4))
    np.testing.assert_allclose(got.bc_values, want.bc_values, **BC_TOL)
    with pytest.raises(ValueError, match="out of range"):
        TP.bfs_batch(gp, [gp.num_nodes], mesh=_mesh(2))


# ---- the CLI -----------------------------------------------------------

SHARD_ARGVS = {
    "bfs": ["bfs", "rmat", "--rmat_scale=8", "--num-shards=4",
            "--mark-pred"],
    "sssp": ["sssp", "rmat", "--rmat_scale=8", "--num-shards=2",
             "--mode=nearfar", "--random-edge-values", "--rmat_seed=3"],
    "pr": ["pr", "rmat", "--rmat_scale=8", "--num-shards=4",
           "--partition-method=biasrandom"],
    "cc": ["cc", "rmat", "--rmat_scale=8", "--num-shards=4",
           "--partition-method=cluster"],
    "bc": ["bc", "rmat", "--rmat_scale=8", "--num-shards=2",
           "--src=largestdegree"],
    "hits": ["hits", "rmat", "--rmat_scale=8", "--num-shards=4",
             "--max-iter=10"],
    "salsa": ["salsa", "rmat", "--rmat_scale=8", "--num-shards=4",
              "--max-iter=10", "--partition-method=static"],
    "wtf": ["wtf", "rmat", "--rmat_scale=8", "--num-shards=2",
            "--src=largestdegree", "--partition-seed=5"],
    "topk": ["topk", "rmat", "--rmat_scale=8", "--num-shards=4",
             "--top-nodes=7", "--partition-method=metis"],
    "tc": ["tc", "rmat", "--rmat_scale=8", "--num-shards=2"],
}


@pytest.mark.parametrize("prim", list(SHARD_ARGVS))
def test_cli_shard_flags_match_jax_cli(prim, capsys, tmp_path):
    """The JAX and port CLIs on the same argv with the shard flags (the
    port's on the CPU): equal validation lines, the sharded primitive in
    the Info record, and equal shard counts and search depths."""
    from gunrock_tpu import cli as jax_cli
    argv = SHARD_ARGVS[prim]
    lines, infos = [], []
    for main, extra, name in ((jax_cli.main, [], "jax"),
                              (cli.main, ["--device=cpu"], "port")):
        out = tmp_path / f"{name}.json"
        assert main(argv + extra + [f"--jsonfile={out}"]) == 0
        lines.append([line for line in capsys.readouterr().out.splitlines()
                      if "validation:" in line])
        infos.append(json.loads(out.read_text()))
    assert lines[0] == lines[1] == [f"{prim} validation: CORRECT"]
    want, got = infos
    assert got["primitive"] == want["primitive"]
    assert got["primitive"].endswith("_sharded")
    for key in ("num_shards", "search_depth", "partition_method",
                "num_iterations", "num_triangles"):
        if key in want:
            assert got[key] == want[key], key


# ---- the twins ---------------------------------------------------------

def test_sharded_example_twin_prints_the_jax_examples_facts(capsys,
                                                            monkeypatch):
    """``examples/sharded_example_torch.py`` on 8 CPU shards against
    ``examples/sharded_example.py`` on the 8 virtual devices: the same
    depth, bytes, top vertex and component count."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for name, argv in (("sharded_example", None),
                       ("sharded_example_torch", ["--device=cpu"])):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main() if argv is None else mod.main(argv)
        out.append([line.split("[")[0].split(";")[0].strip()
                    for line in capsys.readouterr().out.splitlines()])
    assert out[0] == out[1] and len(out[0]) == 4


def test_dryrun_multichip_twin_runs_every_primitive():
    from gunrock_tpu_torch.tools.dryrun_multichip import main
    from gunrock_tpu_torch.tools import dryrun_multichip as dry
    line = dry.dryrun_multichip(4, device="cpu")
    assert "all ten sharded primitives OK" in line and "on cpu" in line
    assert main(["2", "--device=cpu"]) == 0
