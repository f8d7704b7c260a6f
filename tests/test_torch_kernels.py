"""The port's kernel functions against the JAX package's Pallas kernels
(run in interpret mode, as the JAX package's own tests run them on the
CPU). On the CPU the wrappers take the plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions in
tests/test_torch_cuda.py. All comparisons are exact: the functions
compute bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu.ops import pallas_kernels as pk
from gunrock_tpu_torch.ops import kernels as K


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("v", [1, 33, 1000, 4096])
def test_pack_bitmask_words_equal_jax(v):
    mask = np.random.default_rng(v).integers(0, 2, v).astype(bool)
    mask[-1] = True                      # bit 31 of a word in use
    want = np.asarray(pk.pack_bitmask(jnp.asarray(mask))).reshape(-1)
    got = K.pack_bitmask(_t(mask)).numpy()
    assert got.dtype == np.int32 and got.shape == (K.words_for(v),)
    np.testing.assert_array_equal(got, want[:got.shape[0]])
    assert not want[got.shape[0]:].any()
    np.testing.assert_array_equal(K.unpack_bitmask(_t(got), v).numpy(), mask)


@pytest.mark.parametrize("v,n", [(4096, 512), (1 << 15, 1 << 12)])
def test_bitmask_gather_equals_pallas_interpret(v, n):
    rng = np.random.default_rng(1)
    mask = rng.integers(0, 2, v).astype(bool)
    idx = rng.integers(0, v, n).astype(np.int32)
    want = pk.bitmask_gather(pk.pack_bitmask(jnp.asarray(mask)),
                             jnp.asarray(idx), block_rows=2, interpret=True)
    got = K.bitmask_gather(K.pack_bitmask(_t(mask)), _t(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bitmask_gather_any_length_and_out_of_range_ids():
    """No length requirement; ids outside the mask read 0, as in the
    Pallas kernel, whose row loop never matches them."""
    rng = np.random.default_rng(2)
    mask = rng.integers(0, 2, 300).astype(bool)
    words = K.pack_bitmask(_t(mask))
    idx = np.array([-1, -2**31, 0, 5, 299, 300, 319, 320, 2**31 - 1] +
                   list(rng.integers(0, 300, 100)), np.int32)
    got = K.bitmask_gather(words, _t(idx)).numpy()
    inside = (idx >= 0) & (idx < 320)
    want = np.zeros(idx.shape, np.int32)
    want[inside] = pk.bitmask_gather_reference(words.numpy(), idx[inside])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block_rows", [8, 32])
@pytest.mark.parametrize("seed", [5, 9])
def test_pull_reached_words_equals_pallas_interpret(block_rows, seed):
    """Rows 2 (blocked, block_rows 8) and 3 (cells, block_rows 32) of the
    Pallas pull, as tests/test_pallas.py builds them, against the port's
    CSC pull; the unpacked v_pad bits must be equal."""
    gj = gt.io.rmat(scale=10, edge_factor=6, seed=seed, undirected=True)
    dj = gt.to_device(gj, with_csc=True, with_blocked_csc=True,
                      blocked_block_rows=block_rows)
    assert (dj.bcsc_cellword is not None) == (block_rows >= 32)
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 2, dj.v_pad).astype(bool)
    rows = dj.bcsc_groups * dj.bcsc_rows_per_group
    rw = pk.pull_reached_words(pk.pack_bitmask(jnp.asarray(mask), rows=rows),
                               dj, interpret=True)
    want = np.asarray(pk.unpack_bitmask(rw, dj.v_pad))
    dp = gtt.to_device(gtt.io.rmat(scale=10, edge_factor=6, seed=seed,
                                   undirected=True),
                       with_csc=True, device="cpu")
    got = K.pull_reached_words(K.pack_bitmask(_t(mask)), dp)
    assert got.shape == (K.words_for(dp.v_pad),)
    np.testing.assert_array_equal(K.unpack_bitmask(got, dp.v_pad).numpy(),
                                  want)
    assert want.any() and not want.all()


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    g = gtt.to_device(gtt.io.rmat(scale=8, edge_factor=4, seed=1),
                      with_csc=True, device="cpu")
    K.reset_launch_counts()
    words = K.pack_bitmask(torch.ones(g.v_pad, dtype=torch.bool))
    K.pull_reached_words(words, g)
    K.bitmask_gather(words, g.col_indices)
    assert K.LAUNCHES["pull_reached_words"] == 0
    assert K.LAUNCHES["bitmask_gather"] == 0
    with pytest.raises(ValueError, match="with_csc"):
        K.pull_reached_words(words, gtt.to_device(gtt.io.rmat(scale=4),
                                                  device="cpu"))
