"""Host layer of the PyTorch port against the JAX package: the CSR and
CSC builds, the device graph's padded arrays, the market reader and the
binary cache give the same bytes on both sides; and the port imports
nothing of JAX."""

import ast
import os

import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu_torch.graph.device import from_numpy


def _grid_coo(n):
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return n * n, src, dst


BUILDERS = {
    "rmat": lambda m: m.io.rmat(scale=10, edge_factor=8, seed=42,
                                undirected=True),
    "rmat_directed": lambda m: m.io.rmat(scale=9, edge_factor=4, seed=3,
                                         undirected=False),
    "grid": lambda m: m.from_coo(*_grid_coo(32), undirected=True),
    "rgg": lambda m: m.io.rgg(500, seed=4),
    "small_world": lambda m: m.io.small_world(700, seed=5),
}

DEVICE_FIELDS = ("row_offsets", "col_indices", "csc_offsets", "csc_indices",
                 "csc_edge_dst")


def _same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_csr_and_csc_byte_identical(name):
    gj, gp = BUILDERS[name](gt), BUILDERS[name](gtt)
    assert gp.num_nodes == gj.num_nodes and gp.undirected == gj.undirected
    _same_bytes(gp.row_offsets, gj.row_offsets)
    _same_bytes(gp.col_indices, gj.col_indices)
    cj, cp = gj.csc(), gp.csc()
    _same_bytes(cp.row_offsets, cj.row_offsets)
    _same_bytes(cp.col_indices, cj.col_indices)
    _same_bytes(gp.edge_sources(), gj.edge_sources())
    assert gp.largest_degree_vertex() == gj.largest_degree_vertex()


def test_csr_numpy_path_matches_native(monkeypatch):
    """The numpy fallback gives the native builder's arrays."""
    from gunrock_tpu_torch.graph import native
    n, src, dst = _grid_coo(16)
    built = gtt.from_coo(n, src, dst, undirected=True)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = gtt.from_coo(n, src, dst, undirected=True)
    _same_bytes(plain.row_offsets, built.row_offsets)
    _same_bytes(plain.col_indices, built.col_indices)


@pytest.mark.parametrize("name", ["rmat", "rmat_directed", "grid"])
def test_to_device_arrays_equal_jax(name):
    gj, gp = BUILDERS[name](gt), BUILDERS[name](gtt)
    dj = gt.to_device(gj, with_csc=True)
    dp = gtt.to_device(gp, with_csc=True, device="cpu")
    assert (dp.num_nodes, dp.num_edges, dp.v_pad, dp.e_pad) == \
        (dj.num_nodes, dj.num_edges, dj.v_pad, dj.e_pad)
    for f in DEVICE_FIELDS:
        _same_bytes(getattr(dp, f).numpy(), np.asarray(getattr(dj, f)))
    # without the CSC only the forward arrays are built
    assert not gtt.to_device(gp, device="cpu").has_csc


def test_from_numpy_takes_jax_arrays_and_checks_them():
    gj = BUILDERS["rmat"](gt)
    dj = gt.to_device(gj, with_csc=True)
    fields = {f: np.asarray(getattr(dj, f)) for f in DEVICE_FIELDS}
    sizes = dict(num_nodes=dj.num_nodes, num_edges=dj.num_edges,
                 v_pad=dj.v_pad, e_pad=dj.e_pad, device="cpu")
    dp = from_numpy(fields, **sizes)
    for f in DEVICE_FIELDS:
        _same_bytes(getattr(dp, f).numpy(), fields[f])
    bad = dict(fields, col_indices=fields["col_indices"][:-1])
    with pytest.raises(ValueError, match="shape"):
        from_numpy(bad, **sizes)
    off = fields["csc_offsets"].copy()
    off[5], off[6] = off[6], off[5] + 1
    with pytest.raises(ValueError, match="offset"):
        from_numpy(dict(fields, csc_offsets=off), **sizes)
    ids = fields["csc_indices"].copy()
    ids[0] = dj.num_nodes
    with pytest.raises(ValueError, match="vertex ids"):
        from_numpy(dict(fields, csc_indices=ids), **sizes)
    dst = fields["csc_edge_dst"].copy()
    dst[10] += 1
    with pytest.raises(ValueError, match="csc_edge_dst"):
        from_numpy(dict(fields, csc_edge_dst=dst), **sizes)
    with pytest.raises(ValueError, match="together"):
        from_numpy({f: fields[f] for f in DEVICE_FIELDS[:3]}, **sizes)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    g = BUILDERS["grid"](gtt)
    with pytest.raises(RuntimeError, match="CUDA"):
        gtt.to_device(g, with_csc=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        gtt.bfs(g, 0)


MTX = b"""%%MatrixMarket matrix coordinate real general
% comment
5 5 6
1 2 1.5
2 3 2.0
3 1 0.5
4 5 1.0
5 4 3.0
2 3 9.0
"""


@pytest.mark.parametrize("undirected", [None, True])
def test_market_matches_jax(tmp_path, undirected):
    gj = gt.io.parse_market_bytes(MTX, undirected=undirected)
    gp = gtt.io.parse_market_bytes(MTX, undirected=undirected)
    _same_bytes(gp.row_offsets, gj.row_offsets)
    _same_bytes(gp.col_indices, gj.col_indices)
    _same_bytes(gp.edge_values, gj.edge_values)
    path = tmp_path / "g.mtx"
    path.write_bytes(MTX)
    loaded = gtt.io.load_market(str(path), undirected=undirected)
    _same_bytes(loaded.col_indices, gj.col_indices)
    cached = gtt.io.load_market(str(path), undirected=undirected)
    _same_bytes(cached.edge_values, gj.edge_values)
    with pytest.raises(ValueError):
        gtt.io.parse_market_bytes(b"1 2 3\n")


def test_binary_cache_roundtrip(tmp_path):
    g = BUILDERS["rmat"](gtt)
    path = str(tmp_path / "g.csr.npz")
    g.write_binary(path)
    back = gtt.CsrGraph.read_binary(path)
    assert back.num_nodes == g.num_nodes and back.undirected
    _same_bytes(back.row_offsets, g.row_offsets)
    _same_bytes(back.col_indices, g.col_indices)
    # the JAX package reads the port's cache file, and the other way round
    _same_bytes(gt.CsrGraph.read_binary(path).col_indices, g.col_indices)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    pkg = os.path.join(_REPO, "gunrock_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(_REPO, "chip_smoke.py")
    yield os.path.join(_REPO, "examples", "simple_example_torch.py")
    yield os.path.join(_REPO, "examples", "sharded_example_torch.py")


def _forbidden(module: str) -> bool:
    """jax and the JAX package, by module name or dotted prefix (the
    port's own name only shares the prefix's letters)."""
    return any(module == m or module.startswith(m + ".")
               for m in ("jax", "gunrock_tpu"))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of gunrock_tpu_torch (the sharded ``parallel/`` and
    ``tools/dryrun_multichip.py`` among them), chip_smoke.py and the
    examples' twins, parsed: no import of jax or gunrock_tpu, at any
    depth of the file."""
    assert not _forbidden("gunrock_tpu_torch") and _forbidden("jax.numpy")
    checked, bad = 0, []
    paths = {os.path.relpath(p, _REPO) for p in _port_sources()}
    for module in ("capi.py", "utils/track.py", "utils/modularity.py",
                   "utils/baseline.py", "tools/convert.py",
                   "io/generators.py", "tools/dryrun_multichip.py",
                   *(f"parallel/{m}.py" for m in (
                       "__init__", "mesh", "partition", "comm", "blocked",
                       "bfs", "pr", "sssp", "cc", "bc", "hits", "replicate",
                       "wtf", "topk", "tc"))):
        assert os.path.join("gunrock_tpu_torch", module) in paths, module
    assert os.path.join("examples", "sharded_example_torch.py") in paths
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        checked += 1
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, _REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert checked > 30 and not bad, bad
