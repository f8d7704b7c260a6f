"""The rest of the port's operators and the template primitive against
the JAX package: ``expand_inverse`` on its active lanes, ``pull_reduce``
(sum, max, min on float32 and int32 values, with empty and pad
segments), ``cull_filter`` and ``bypass_filter``, and ``sample``.

Tolerances: lanes, ids, labels, int reductions and float min/max are
exact; float sums carry rtol 1e-6 (the port sums a segment in float64,
the JAX package in float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu.ops import advance as jadv
from gunrock_tpu.ops import filter as jfil
from gunrock_tpu_torch.ops import advance as tadv
from gunrock_tpu_torch.ops import filter as tfil


def _grid(mod, n):
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return mod.from_coo(n * n, src, dst, undirected=True)


@pytest.fixture(scope="module")
def csc_graphs():
    """Directed R-MAT (in- and out-rows differ) with isolated vertices
    and ``v_pad > num_nodes``: empty and pad segments."""
    gj = gt.io.rmat(scale=10, edge_factor=4, seed=9)
    gp = gtt.io.rmat(scale=10, edge_factor=4, seed=9)
    dj = gt.to_device(gj, with_csc=True)
    dp = gtt.to_device(gp, with_csc=True, device="cpu")
    assert dp.v_pad > dp.num_nodes or (np.diff(gp.csc().row_offsets) == 0
                                       ).any()
    return dj, dp


@pytest.mark.parametrize("n", [1, 9, 300])
def test_expand_inverse_lanes_equal_jax(csc_graphs, n):
    dj, dp = csc_graphs
    rng = np.random.default_rng(n)
    frontier = rng.choice(dj.num_nodes, n, replace=False).astype(np.int32)
    buf = np.zeros(512, np.int32)
    buf[:n] = frontier
    exj = jadv.expand_inverse(dj, jnp.asarray(buf), jnp.int32(n), 1 << 14)
    exp = tadv.expand_inverse(dp, torch.from_numpy(frontier))
    total = int(exj.total)
    assert exp.total == total and int(np.asarray(exj.mask).sum()) == total
    for f in ("src", "dst", "eid", "rank"):
        np.testing.assert_array_equal(getattr(exp, f).numpy(),
                                      np.asarray(getattr(exj, f))[:total],
                                      err_msg=f)
    # dst lanes are in-neighbors: each (dst, src) is a forward edge
    row = dp.row_offsets.long()
    for u, v in zip(exp.dst.tolist()[:200], exp.src.tolist()[:200]):
        assert v in dp.col_indices[row[u]:row[u + 1]].tolist()


def test_expand_inverse_needs_the_csc():
    g = gtt.to_device(gtt.io.rmat(scale=6, edge_factor=4, seed=1),
                      device="cpu")
    with pytest.raises(ValueError, match="with_csc"):
        tadv.expand_inverse(g, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="with_csc"):
        tadv.pull_reduce(g, torch.zeros(g.e_pad))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_pull_reduce_equals_jax(csc_graphs, op, dtype):
    dj, dp = csc_graphs
    rng = np.random.default_rng(3)
    if dtype == "float32":
        # positive, as the pulls' weights are: no cancellation, so the
        # JAX package's float32 sums stay within rtol 1e-6
        vals = rng.uniform(0.5, 1.5, dj.e_pad).astype(np.float32)
    else:
        vals = rng.integers(-1000, 1000, dj.e_pad).astype(np.int32)
    want = np.asarray(jadv.pull_reduce(dj, jnp.asarray(vals), op=op))
    got = tadv.pull_reduce(dp, torch.from_numpy(vals), op=op).numpy()
    assert got.shape == (dp.v_pad,) and got.dtype == want.dtype
    empty = np.diff(np.asarray(dj.csc_offsets)) == 0
    assert empty.any() and empty[dp.num_nodes:].all()
    if op == "sum" and dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6)
        ref = np.zeros(dp.v_pad)
        np.add.at(ref, np.asarray(dj.csc_edge_dst)[:dj.num_edges],
                  vals[:dj.num_edges].astype(np.float64))
        np.testing.assert_array_equal(got, ref.astype(np.float32))
    else:
        np.testing.assert_array_equal(got, want)
    ident = {"sum": 0,
             "max": -np.inf if dtype == "float32" else
             np.iinfo(np.int32).min,
             "min": np.inf if dtype == "float32" else
             np.iinfo(np.int32).max}[op]
    assert (got[empty] == ident).all()
    with pytest.raises(ValueError, match="unknown op"):
        tadv.pull_reduce(dp, torch.from_numpy(vals), op="prod")


def _odd(x):
    return x % 2 == 1


@pytest.mark.parametrize("cond", [None, _odd])
@pytest.mark.parametrize("dedup", [True, False])
def test_cull_filter_equals_jax(cond, dedup):
    rng = np.random.default_rng(1 + dedup)
    items = rng.integers(0, 60, 500).astype(np.int32)
    mask = rng.random(500) < 0.6
    jf, jn, jkeep = jfil.cull_filter(jnp.asarray(items), jnp.asarray(mask),
                                     size=64, cap=512, cond=cond,
                                     dedup=dedup)
    tf, tn, tkeep = tfil.cull_filter(torch.from_numpy(items),
                                     torch.from_numpy(mask), size=64,
                                     cond=cond, dedup=dedup)
    assert tn == int(jn) and tf.shape == (tn,)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf)[:tn])
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if dedup:
        assert len(set(tf.tolist())) == tn


@pytest.mark.parametrize("cond", [None, _odd])
def test_bypass_filter_equals_jax(cond):
    rng = np.random.default_rng(4)
    items = rng.integers(0, 60, 300).astype(np.int32)
    mask = rng.random(300) < 0.5
    want = jfil.bypass_filter(jnp.asarray(items), jnp.asarray(mask),
                              cond=cond)
    got = tfil.bypass_filter(torch.from_numpy(items), torch.from_numpy(mask),
                             cond=cond)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SAMPLE_GRAPHS = {
    "rmat": lambda m: m.io.rmat(scale=11, edge_factor=8, seed=3,
                                undirected=True),
    "grid32": lambda m: _grid(m, 32),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_GRAPHS))
def test_sample_equals_jax(name):
    gj, gp = SAMPLE_GRAPHS[name](gt), SAMPLE_GRAPHS[name](gtt)
    src = gp.largest_degree_vertex() if name == "rmat" else 0
    want = gt.sample(gj, src)
    got = gtt.sample(gp, src, device="cpu")
    np.testing.assert_array_equal(got, want)
    from gunrock_tpu_torch.utils.reference import cpu_bfs
    np.testing.assert_array_equal(got, cpu_bfs(gp, src))
    # an uploaded graph runs where it lies
    dp = gtt.to_device(gp, device="cpu")
    np.testing.assert_array_equal(gtt.sample(dp, src), want)
    with pytest.raises(ValueError, match="out of range"):
        gtt.sample(dp, gp.num_nodes)
