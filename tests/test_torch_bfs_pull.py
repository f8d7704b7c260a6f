"""The BFS pull without the blocked CSC: kernel K10's plain version
(``bitmask_gather_cumsum``) against the JAX package's Pallas kernel in
interpret mode and against numpy, the port's pull step on a graph
uploaded ``with_csc`` only against the JAX package's accelerator route,
and the ``has_blocked_csc`` flag that chooses between K1 and K10. All
comparisons are exact: the functions compute bits and counts."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu.enactor import init_stats
from gunrock_tpu.ops import pallas_kernels as pk
from gunrock_tpu_torch.enactor import LoopStats
from gunrock_tpu_torch.graph.device import from_numpy
from gunrock_tpu_torch.ops import kernels as K

# the packages' models/__init__ rebinds "bfs" to the function
jbfs = importlib.import_module("gunrock_tpu.models.bfs")
tbfs = importlib.import_module("gunrock_tpu_torch.models.bfs")

_GRAPH_FIELDS = ("row_offsets", "col_indices", "csc_offsets", "csc_indices",
                 "csc_edge_dst")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("v,n", [(4096, 1024), (1 << 15, 1 << 13)])
def test_gather_cumsum_plain_equals_pallas_interpret(v, n):
    """At the shapes of tests/test_pallas.py; the JAX package's (R, 128)
    words, read row-major, are the port's flat words."""
    rng = np.random.default_rng(2)
    mask = rng.integers(0, 2, v).astype(bool)
    words = pk.pack_bitmask(jnp.asarray(mask))
    idx = rng.integers(0, v, n).astype(np.int32)
    want = pk.bitmask_gather_cumsum(words, jnp.asarray(idx), block_rows=2,
                                    interpret=True)
    flat = _t(np.asarray(words).reshape(-1))
    got = K.bitmask_gather_cumsum(flat, _t(idx))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        K.bitmask_gather_cumsum_plain(K.pack_bitmask(_t(mask)), _t(idx)),
        got)


@pytest.mark.parametrize("n", [0, 1, 1001])
def test_gather_cumsum_any_length_against_numpy(n):
    """No length requirement; ids outside the mask read 0."""
    rng = np.random.default_rng(n)
    mask = rng.integers(0, 2, 300).astype(bool)
    idx = rng.integers(-50, 400, n).astype(np.int32)
    got = K.bitmask_gather_cumsum(K.pack_bitmask(_t(mask)), _t(idx))
    inside = (idx >= 0) & (idx < 320)
    bits = np.zeros(n, np.int64)
    bits[inside] = np.concatenate([mask, np.zeros(20, bool)])[idx[inside]]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.cumsum(bits))


def _jax_graph(**kw):
    gj = gt.io.rmat(scale=10, edge_factor=8, seed=42, undirected=True)
    return gj, gt.to_device(gj, with_csc=True, **kw)


def _port_graph(dj, **kw):
    return from_numpy({f: np.asarray(getattr(dj, f)) for f in _GRAPH_FIELDS},
                      num_nodes=dj.num_nodes, num_edges=dj.num_edges,
                      v_pad=dj.v_pad, e_pad=dj.e_pad, device="cpu", **kw)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_pull_step_without_blocked_csc_equals_jax_pallas_route(level,
                                                              monkeypatch):
    """One pull level from the same mid-traversal labels: the JAX
    package's accelerator route through bitmask_gather_cumsum (interpret
    mode, patched in as tests/test_pallas.py does) against the port's
    route for graphs without the blocked CSC."""
    gj, dj = _jax_graph()
    assert not dj.has_blocked_csc
    src = gj.largest_degree_vertex()
    full = gt.bfs(gj, src).labels
    labels = np.full(dj.v_pad, -1, np.int32)
    labels[:gj.num_nodes] = np.where(full <= level, full, -1)
    st = jbfs._State(
        labels=jnp.asarray(labels), preds=jnp.zeros((1,), jnp.int32),
        frontier=jnp.zeros((dj.v_pad,), jnp.int32), n=jnp.int32(1),
        m_f=jnp.int32(0), fvalid=jnp.bool_(False), use_pull=jnp.bool_(True),
        unexplored=jnp.float32(0),
        stats=dataclasses.replace(init_stats(), iteration=jnp.int32(level)))
    orig = pk.bitmask_gather_cumsum
    monkeypatch.setattr(pk, "bitmask_gather_cumsum",
                        lambda w, i, **kw: orig(w, i, interpret=True, **kw))
    want = jbfs._pull_step(dj, dj.v_pad, False, st, use_pallas=True)

    dp = _port_graph(dj)
    assert dp.has_csc and not dp.has_blocked_csc
    state = tbfs._State(labels=_t(labels.copy()), preds=None, frontier=None,
                        n=1, m_f=0, fvalid=False, use_pull=True,
                        stats=LoopStats(iteration=level))
    edges = tbfs._pull_step(dp, state, level + 1)
    np.testing.assert_array_equal(state.labels.numpy(), np.asarray(want[0]))
    assert (state.n, state.m_f, edges) == \
        (int(want[3]), int(want[4]), int(want[6]))
    assert state.n > 0


def test_both_pull_routes_give_one_traversal():
    """DO-BFS with predecessors on a with_csc-only graph (K10's route)
    equals the run on a with_blocked_csc graph (K1's); both pull."""
    g = gtt.io.rmat(scale=10, edge_factor=8, seed=42, undirected=True)
    src = g.largest_degree_vertex()
    runs = []
    for kw in ({"with_csc": True}, {"with_blocked_csc": True}):
        dg = gtt.to_device(g, device="cpu", **kw)
        records = []
        runs.append(tbfs.bfs_device(dg, src, mark_preds=True,
                                    direction_optimized=True,
                                    instrument=records))
        assert "pull" in [r["phase"] for r in records]
    (la, pa, sa), (lb, pb, sb) = runs
    assert torch.equal(la, lb) and torch.equal(pa, pb)
    assert sa.frontier_trace == sb.frontier_trace


@pytest.mark.parametrize("kw", [
    {"with_csc": True}, {"with_blocked_csc": True},
    {"with_csc": True, "with_blocked_csc": True},
    {"with_blocked_values": True},
    {"with_blocked_values": True, "with_blocked_csc": True}])
@pytest.mark.parametrize("scale", [8, 12])
def test_has_blocked_csc_follows_jax(kw, scale):
    """``has_blocked_csc`` as the JAX package sets it: asked for, or
    implied by ``with_blocked_values`` where no pull-v2 layout fits
    (scale 8: v_pad 256). The CSC is built either way."""
    gj = gt.io.rmat(scale=scale, edge_factor=4, seed=3, undirected=True)
    dj = gt.to_device(gj, **kw)
    gp = gtt.io.rmat(scale=scale, edge_factor=4, seed=3, undirected=True)
    dp = gtt.to_device(gp, device="cpu", **kw)
    assert dp.has_blocked_csc == dj.has_blocked_csc
    assert dp.has_pull2 == dj.has_pull2
    assert dp.has_csc
    np.testing.assert_array_equal(dp.csc_indices.numpy(),
                                  np.asarray(gt.to_device(
                                      gj, with_csc=True).csc_indices))


def test_from_numpy_carries_the_flag_from_a_jax_graph():
    _, dj = _jax_graph(with_blocked_csc=True)
    assert dj.has_blocked_csc
    dp = _port_graph(dj, with_blocked_csc=dj.has_blocked_csc)
    assert dp.has_blocked_csc and dp.has_csc
    # without the CSC's keys the flag builds the CSC from the CSR
    bare = from_numpy({f: np.asarray(getattr(dj, f))
                       for f in ("row_offsets", "col_indices")},
                      num_nodes=dj.num_nodes, num_edges=dj.num_edges,
                      v_pad=dj.v_pad, e_pad=dj.e_pad, device="cpu",
                      with_blocked_csc=True)
    assert bare.has_blocked_csc
    np.testing.assert_array_equal(bare.csc_indices.numpy(),
                                  np.asarray(dj.csc_indices))
    assert not _port_graph(dj).has_blocked_csc


def test_gather_cumsum_wrapper_counts_no_launch_on_cpu():
    K.reset_launch_counts()
    words = K.pack_bitmask(torch.ones(64, dtype=torch.bool))
    out = K.bitmask_gather_cumsum(words, torch.arange(10, dtype=torch.int32))
    assert out.tolist() == list(range(1, 11))
    assert K.LAUNCHES["bitmask_gather_cumsum"] == 0
    with pytest.raises(ValueError, match="tensors on"):
        K.bitmask_gather_cumsum(words, torch.zeros(3, dtype=torch.int32,
                                                   device="meta"))
