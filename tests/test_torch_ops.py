"""The port's operators against the JAX package's: the advance lanes, the
claim dedup's winners, compaction and the scatters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu.ops import advance as jadv
from gunrock_tpu.ops import segment as jseg
from gunrock_tpu_torch.ops import advance as tadv
from gunrock_tpu_torch.ops import segment as tseg


@pytest.fixture(scope="module")
def graphs():
    gj = gt.io.rmat(scale=10, edge_factor=8, seed=42, undirected=True)
    gp = gtt.io.rmat(scale=10, edge_factor=8, seed=42, undirected=True)
    return gt.to_device(gj), gtt.to_device(gp, device="cpu")


@pytest.mark.parametrize("n", [1, 7, 300])
def test_expand_lanes_equal_jax(graphs, n):
    dj, dp = graphs
    rng = np.random.default_rng(n)
    frontier = np.sort(rng.choice(dj.num_nodes, n, replace=False)) \
        .astype(np.int32)
    buf = np.zeros(512, np.int32)
    buf[:n] = frontier
    exj = jadv.expand(dj, jnp.asarray(buf), jnp.int32(n), 1 << 15,
                      sorted_frontier=True)
    exp = tadv.expand(dp, torch.from_numpy(frontier))
    total = int(exj.total)
    assert exp.total == total and int(np.asarray(exj.mask).sum()) == total
    for f in ("src", "dst", "eid", "rank"):
        np.testing.assert_array_equal(getattr(exp, f).numpy(),
                                      np.asarray(getattr(exj, f))[:total],
                                      err_msg=f)


def test_expand_zero_degree_and_empty_frontier():
    g = gtt.to_device(gtt.from_coo(6, [0, 0, 3], [1, 2, 4]), device="cpu")
    ex = tadv.expand(g, torch.tensor([0, 1, 3, 5], dtype=torch.int32))
    assert ex.total == 3
    assert ex.src.tolist() == [0, 0, 3] and ex.dst.tolist() == [1, 2, 4]
    assert ex.rank.tolist() == [0, 0, 2]
    empty = tadv.expand(g, torch.zeros(0, dtype=torch.int32))
    assert empty.total == 0 and empty.dst.shape == (0,)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_winners_equal_jax(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 50, 400).astype(np.int32)
    mask = rng.random(400) < 0.7
    want = np.asarray(jseg.dedup_winners(jnp.asarray(idx), jnp.asarray(mask),
                                         64))
    got = tseg.dedup_winners(torch.from_numpy(idx), torch.from_numpy(mask),
                             64).numpy()
    np.testing.assert_array_equal(got, want)
    # one winner per active index: its highest active lane
    for v in np.unique(idx[mask]):
        lanes = np.nonzero((idx == v) & mask)[0]
        assert got[lanes].sum() == 1 and got[lanes[-1]]


def test_compact_and_frontier_masks_equal_jax():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1000, 200).astype(np.int32)
    mask = rng.random(200) < 0.4
    bj, nj = jseg.compact(jnp.asarray(vals), jnp.asarray(mask), 256)
    got, n = tseg.compact(torch.from_numpy(vals), torch.from_numpy(mask))
    assert n == int(nj)
    np.testing.assert_array_equal(got.numpy(), np.asarray(bj)[:n])
    fj, fnj = jseg.frontier_from_mask(jnp.asarray(mask), 256)
    fp, fnp = tseg.frontier_from_mask(torch.from_numpy(mask))
    assert fnp == int(fnj) and fp.dtype == torch.int32
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fj)[:fnp])
    mj = jseg.mask_from_frontier(fj, fnj, 200)
    np.testing.assert_array_equal(
        tseg.mask_from_frontier(fp, 200).numpy(), np.asarray(mj))


@pytest.mark.parametrize("op", ["min", "max", "add"])
def test_scatter_reductions_equal_jax_in_place(op):
    rng = np.random.default_rng(4)
    dest = rng.integers(-50, 50, 40).astype(np.int32)
    idx = rng.integers(0, 40, 100).astype(np.int32)
    vals = rng.integers(-80, 80, 100).astype(np.int32)
    mask = rng.random(100) < 0.6
    jfn = getattr(jseg, f"scatter_{op}")
    want = np.asarray(jfn(jnp.asarray(dest), jnp.asarray(idx),
                          jnp.asarray(vals), mask=jnp.asarray(mask)))
    d = torch.from_numpy(dest.copy())
    out = getattr(tseg, f"scatter_{op}")(d, torch.from_numpy(idx),
                                        torch.from_numpy(vals),
                                        mask=torch.from_numpy(mask))
    assert out is d                        # updated in place
    np.testing.assert_array_equal(d.numpy(), want)


def test_scatter_set_unique_indices_and_scalar_values():
    dest = torch.full((10,), -1, dtype=torch.int32)
    idx = torch.tensor([3, 1, 7, 3], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True])
    tseg.scatter_set(dest, idx, 5, mask=mask)
    want = np.asarray(jseg.scatter_set(jnp.full((10,), -1, jnp.int32),
                                       jnp.asarray(idx.numpy()), 5,
                                       mask=jnp.asarray(mask.numpy())))
    np.testing.assert_array_equal(dest.numpy(), want)
