"""The CUDA kernels and the DO-BFS path on the card, against the plain
PyTorch versions on the same inputs. Every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one. The file imports neither jax
nor the JAX package, so it also runs where only the port is installed:

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
def test_bfs_on_cuda_equals_cpu_and_launches_kernels(cuda):
    g = gtt.io.rmat(scale=10, edge_factor=8, seed=42, undirected=True)
    want = gtt.bfs(g, "largestdegree", mark_preds=True,
                   direction_optimized=True, alpha=0.05, device="cpu")
    K.reset_launch_counts()
    got = gtt.bfs(g, "largestdegree", mark_preds=True,
                  direction_optimized=True, alpha=0.05, device="cuda")
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.preds, want.preds)
    assert min(K.LAUNCHES.values()) > 0
