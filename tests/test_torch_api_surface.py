"""The port's public surface against the JAX package's.

Module by module, both packages are parsed with ``ast`` (nothing is imported): for each
module of ``gunrock_tpu`` the public top-level functions, classes and
constants, each class's public methods and fields, and in an
``__init__.py`` the names it imports. Its counterpart in
``gunrock_tpu_torch`` is the module of the same path
(``ops/pallas_kernels.py`` maps to ``ops/kernels.py``). A public JAX
name that the port's counterpart lacks must be listed in
:data:`NOT_PORTED` with its reason, and every entry there must still
name something the port lacks.

Then the names the audit found missing, against the JAX package's on the
same inputs: ``DeviceGraph.has_edge_values``, ``out_degree(v)`` and
``in_degree(v)`` (exact, dtype included, int32 and sizet64 offsets), and
``graph.native.parse_market_body_native`` (exact) against
``gunrock_tpu.io.market.parse_market_bytes`` and the JAX binding of the
same C function. The port's native library is built in its own
per-process file; the JAX package's native library is never used.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu.graph import native as jnative
from gunrock_tpu_torch.graph import native as tnative

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX = os.path.join(_REPO, "gunrock_tpu")
_PORT = os.path.join(_REPO, "gunrock_tpu_torch")
_RENAMED = {"ops/pallas_kernels.py": "ops/kernels.py"}

_LAYOUTS = ("not ported: the blocked-CSC and pv2 layouts (ROADMAP.md, "
            "Ground rules, 'Not ported'); the port keeps only their "
            "routing flags")
_ENACTOR = ("not ported: the JAX enactor's compile-time helpers and "
            "chunking (ROADMAP.md, 'Not ported'); the port's host loops "
            "size each step as it runs")
_SHARD_MAP = ("not ported: shard_map helpers (ROADMAP.md, 'Not ported'); "
              "the port's Mesh runs each shard's body itself")
_XLA = ("not ported: an XLA idiom with no torch meaning (ROADMAP.md, "
        "'Not ported')")

# "module:name" (fnmatch patterns allowed in the name) -> the reason.
NOT_PORTED = {
    "graph/device.py:DeviceGraph.bcsc_*": _LAYOUTS,
    "graph/device.py:DeviceGraph.pv2_*": _LAYOUTS,
    "graph/device.py:build_blocked_csc": _LAYOUTS,
    "graph/device.py:build_blocked_rect": _LAYOUTS,
    "graph/pull2.py:*": _LAYOUTS + " (the whole pv2 builder module)",
    "parallel/blocked.py:ShardedBlocked.bcsc_*": _LAYOUTS,
    "parallel/blocked.py:ShardedBlocked.has_blocked_values": _LAYOUTS,
    "parallel/blocked.py:build_sharded_blocked": _LAYOUTS,
    "parallel/blocked.py:build_sharded_blocked_from_lists": _LAYOUTS,
    "parallel/blocked.py:local_layout": _LAYOUTS,
    "models/hits.py:reverse_blocked": _LAYOUTS,
    "ops/pallas_kernels.py:pull_vertex_reduce": _LAYOUTS
    + "; K3 computes its function (ops/kernels.pull_reduce2)",
    "ops/pallas_kernels.py:blocked_pull_or": _LAYOUTS
    + "; K1 computes its function (ops/kernels.pull_reached_words)",
    "ops/pallas_kernels.py:pad_values_table": _LAYOUTS
    + " (the v1 sampled value pipeline)",
    "ops/pallas_kernels.py:LANE": _LAYOUTS + " (a TPU tile width)",
    "ops/pallas_kernels.py:DEFAULT_BLOCK_ROWS": _LAYOUTS
    + " (a TPU tile height)",
    "ops/pull2.py:LANE": _LAYOUTS + " (a TPU tile width)",
    "ops/pull2.py:PULL2_MAX_ROWS": _LAYOUTS + " (a pv2 window bound)",
    "ops/pallas_kernels.py:bitmask_gather_reference":
        "renamed: the port's counterpart is "
        "ops/kernels.bitmask_gather_plain",
    "graph/native.py:build_capi_lib":
        "moved: the port's counterpart is capi.build_capi_lib",
    "enactor.py:frontier_ladder": _ENACTOR,
    "enactor.py:dispatch_by_size": _ENACTOR,
    "enactor.py:reset_chunk": _ENACTOR,
    "enactor.py:i32_clip": _ENACTOR,
    "enactor.py:init_stats": _ENACTOR,
    "enactor.py:TRACE_LEN": _ENACTOR,
    "enactor.py:LoopStats.chunk_edges": _ENACTOR,
    "utils/__init__.py:honor_jax_platforms":
        "not ported: JAX platform selection (ROADMAP.md, 'Not ported'); "
        "the port takes device=",
    "parallel/mesh.py:pvary": _SHARD_MAP,
    "parallel/mesh.py:replicated": _SHARD_MAP,
    "parallel/mesh.py:shard_leading": _SHARD_MAP,
    "parallel/blocked.py:ShardedBlocked.specs": _SHARD_MAP
    + " (PartitionSpecs for shard_map)",
    "ops/segment.py:masked_idx": _XLA
    + " (an out-of-range index dropped by mode='drop')",
    "ops/advance.py:ExpandedEdges.mask": _XLA
    + " (padded lanes; the port's lanes are exact-size)",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def public_names(path: str) -> set[str]:
    """The public names a module defines (see the module docstring)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    init = os.path.basename(path) == "__init__.py"
    out: set[str] = set()

    def targets(node):
        if isinstance(node, ast.Assign):
            return [t.id for t in node.targets if isinstance(t, ast.Name)]
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                           ast.Name):
            return [node.target.id]
        return []

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _public(node.name):
                    out.add(node.name)
            elif isinstance(node, ast.ClassDef):
                if not _public(node.name):
                    continue
                out.add(node.name)
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        found = [m.name]
                    else:
                        found = targets(m)
                    out.update(f"{node.name}.{n}" for n in found
                               if _public(n))
            elif isinstance(node, (ast.If, ast.Try)):
                walk(node.body)
                walk(node.orelse)
                for h in getattr(node, "handlers", []):
                    walk(h.body)
            elif init and isinstance(node, ast.ImportFrom):
                out.update(a.asname or a.name for a in node.names
                           if _public(a.asname or a.name))
            else:
                out.update(n for n in targets(node) if _public(n))

    walk(tree.body)
    return out


def _jax_modules() -> list[str]:
    mods = []
    for root, dirs, files in os.walk(_JAX):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        mods += [os.path.relpath(os.path.join(root, f), _JAX)
                 for f in sorted(files) if f.endswith(".py")]
    return sorted(mods)


def _listed(module: str, name: str) -> bool:
    return any(mod == module and fnmatch.fnmatchcase(name, pat)
               for mod, pat in (k.split(":", 1) for k in NOT_PORTED))


def _missing(module: str) -> set[str]:
    want = public_names(os.path.join(_JAX, module))
    port = os.path.join(_PORT, _RENAMED.get(module, module))
    have = public_names(port) if os.path.exists(port) else set()
    return want - have


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_jax_name_is_ported_or_listed(module):
    """Every public name of the JAX module is in its counterpart or in
    NOT_PORTED, and every NOT_PORTED entry of the module still matches
    a name the port lacks (no stale entries)."""
    missing = _missing(module)
    unlisted = sorted(n for n in missing if not _listed(module, n))
    assert not unlisted, (f"gunrock_tpu/{module}: public names missing in "
                          f"the port and not in NOT_PORTED: {unlisted}")
    for key in NOT_PORTED:
        mod, pat = key.split(":", 1)
        if mod == module:
            assert any(fnmatch.fnmatchcase(n, pat) for n in missing), (
                f"NOT_PORTED[{key!r}] matches nothing the port lacks")


def test_not_ported_table_is_well_formed():
    """Each entry names a JAX module and gives its reason: ROADMAP.md's
    'Not ported' bullet, or the port's counterpart."""
    modules = set(_jax_modules())
    for key, reason in NOT_PORTED.items():
        mod, _, pat = key.partition(":")
        assert mod in modules and pat, key
        assert "ROADMAP.md" in reason or "counterpart is" in reason, key
    with open(os.path.join(_REPO, "ROADMAP.md")) as f:
        assert "**Not ported.**" in f.read()


def test_collector_sees_defs_fields_methods_and_init_imports(tmp_path):
    """The collector itself, on a module of each kind."""
    mod = tmp_path / "m.py"
    mod.write_text(
        "import numpy as np\nfrom x import y\nLANE = 128\n_P = 1\n"
        "def f(): pass\ndef _g(): pass\n"
        "class C:\n    a: int\n    _b: int\n    K = 1\n"
        "    def m(self): pass\n    def _n(self): pass\n"
        "try:\n    def t(): pass\nexcept ImportError:\n    pass\n")
    assert public_names(str(mod)) == {"LANE", "f", "C", "C.a", "C.K",
                                      "C.m", "t"}
    init = tmp_path / "__init__.py"
    init.write_text("from . import a, b as _b\nfrom .c import D\n")
    assert public_names(str(init)) == {"a", "D"}


# ---------------------------------------------------------------------
# DeviceGraph's degree members and has_edge_values (R-MAT scale 9).

GRAPH = dict(scale=9, edge_factor=8, seed=3, undirected=True)


def _graphs(values: bool):
    jg, tg = gt.io.rmat(**GRAPH), gtt.io.rmat(**GRAPH)
    assert np.array_equal(jg.row_offsets, tg.row_offsets)
    assert np.array_equal(jg.col_indices, tg.col_indices)
    if values:
        jg.random_edge_values(seed=7)
        tg.random_edge_values(seed=7)
    return jg, tg


def _ids(n: int) -> dict:
    rng = np.random.default_rng(11)
    return {"all": np.arange(n, dtype=np.int32),
            "random": rng.integers(0, n, 300).astype(np.int32)}


@pytest.mark.parametrize("values,upload", [
    (False, {}), (False, {"with_edge_values": True}),
    (True, {}), (True, {"with_edge_values": True}),
    (True, {"with_csc": True, "with_edge_values": True})])
def test_has_edge_values_equals_jax(values, upload):
    jg, tg = _graphs(values)
    jd = gt.to_device(jg, **upload)
    td = gtt.to_device(tg, **upload, device="cpu")
    assert td.has_edge_values == jd.has_edge_values
    assert td.has_edge_values == upload.get("with_edge_values", False)


@pytest.mark.parametrize("which", ["all", "random"])
def test_out_and_in_degree_equal_jax(which):
    jg, tg = _graphs(False)
    jd = gt.to_device(jg, with_csc=True)
    td = gtt.to_device(tg, with_csc=True, device="cpu")
    v = _ids(jg.num_nodes)[which]
    for member in ("out_degree", "in_degree"):
        want = np.asarray(getattr(jd, member)(jnp.asarray(v)))
        got = getattr(td, member)(torch.from_numpy(v))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        assert np.array_equal(got.numpy(), want), member
    # the undirected graph's in-degrees are its out-degrees
    assert torch.equal(td.in_degree(torch.from_numpy(v)),
                       td.out_degree(torch.from_numpy(v)))


def test_in_degree_without_csc_raises():
    _, tg = _graphs(False)
    td = gtt.to_device(tg, device="cpu")
    assert td.out_degree(torch.tensor([0, 1])).shape == (2,)
    with pytest.raises(ValueError, match="with_csc"):
        td.in_degree(torch.tensor([0, 1]))


JAX_X64_DEGREES = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
import jax.numpy as jnp
import numpy as np
import gunrock_tpu as gt

g = gt.io.rmat(**GRAPH)
dg = gt.to_device(g, with_csc=True, sizet64=True)
out = {}
for which, v in IDS.items():
    out["out_" + which] = np.asarray(dg.out_degree(jnp.asarray(v)))
    out["in_" + which] = np.asarray(dg.in_degree(jnp.asarray(v)))
out["offsets_dtype"] = str(dg.row_offsets.dtype)
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax64_degrees(tmp_path_factory):
    """The JAX package's degree members on its sizet64 upload, from one
    x64 subprocess (as ``test_torch_sizet64.py``'s ``jax64`` fixture
    runs the JAX package in x64 mode)."""
    ids = {k: v.tolist() for k, v in _ids(2 ** GRAPH["scale"]).items()}
    code = (JAX_X64_DEGREES.replace("GRAPH", f"dict(**{GRAPH!r})")
            .replace("IDS", f"{{k: np.array(v, dtype=np.int64) for k, v "
                            f"in {ids!r}.items()}}"))
    path = str(tmp_path_factory.mktemp("degrees64") / "jax64.npz")
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, _REPO, path], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "OK" in out.stdout, out.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("which", ["all", "random"])
def test_degrees_on_sizet64_equal_jax_x64(jax64_degrees, which):
    """On a sizet64 upload both packages return int64 degrees."""
    assert jax64_degrees["offsets_dtype"] == "int64"
    _, tg = _graphs(False)
    td = gtt.to_device(tg, with_csc=True, sizet64=True, device="cpu")
    assert td.sizet64
    v = torch.from_numpy(_ids(tg.num_nodes)[which])
    for member, key in (("out_degree", "out_"), ("in_degree", "in_")):
        got = getattr(td, member)(v)
        want = jax64_degrees[key + which]
        assert got.dtype == torch.int64 and want.dtype == np.int64
        assert np.array_equal(got.numpy(), want), member


# ---------------------------------------------------------------------
# The native Matrix Market body parser.

def _market(kind: str):
    """(file bytes, body bytes, line count, has_values) of a general
    (non-symmetric) graph of 60 vertices with unique edges and no self
    loops, so that the CSR build keeps every parsed line. "comments"
    puts comment lines between the banner and the size line, where
    ``parse_market_bytes`` reads them (it parses the body as numbers)."""
    rng = np.random.default_rng({"valued": 1, "pattern": 2,
                                 "comments": 3}[kind])
    n = 60
    pairs = rng.choice(n * n, 400, replace=False)
    r, c = pairs // n, pairs % n
    keep = r != c
    r, c = r[keep] + 1, c[keep] + 1
    w = rng.uniform(0.0, 64.0, r.size)
    has_values = kind != "pattern"
    lines = [f"{a} {b} {x:.6f}" if has_values else f"{a} {b}"
             for a, b, x in zip(r, c, w)]
    body = ("\n".join(lines) + "\n").encode()
    field = "real" if has_values else "pattern"
    notes = "% a comment line\n" * (5 if kind == "comments" else 0)
    head = (f"%%MatrixMarket matrix coordinate {field} general\n{notes}"
            f"{n} {n} {r.size}\n").encode()
    return head + body, body, len(lines), has_values


def _with_comment_lines(body: bytes, seed: int) -> bytes:
    """The body with 5 comment lines put between its lines (the native
    parser skips them; each still counts towards ``nnz_max``)."""
    lines = body.decode().splitlines()
    rng = np.random.default_rng(seed)
    for at in sorted(rng.choice(len(lines), 5, replace=False),
                     reverse=True):
        lines.insert(int(at), "% a comment line")
    return ("\n".join(lines) + "\n").encode()


@pytest.fixture(scope="module")
def port_lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native parser cannot be built")
    lib = tnative.get_lib()
    assert lib is not None, "the port's native library did not build"
    return lib


@pytest.mark.parametrize("kind", ["valued", "pattern", "comments"])
def test_parse_market_body_native_equals_jax_parse(port_lib, kind):
    data, body, lines, has_values = _market(kind)
    out = tnative.parse_market_body_native(body, lines, has_values)
    assert out is not None
    src, dst, vals = out
    assert src.dtype == np.int32 and dst.dtype == np.int32
    assert (vals is None) == (not has_values)
    if has_values:
        assert vals.dtype == np.float32
    want = gt.io.parse_market_bytes(data, undirected=False)
    got = gtt.from_coo(want.num_nodes, src, dst, vals, undirected=False)
    assert got.num_edges == src.size == want.num_edges
    assert np.array_equal(got.row_offsets, want.row_offsets)
    assert np.array_equal(got.col_indices, want.col_indices)
    if has_values:
        assert np.array_equal(got.edge_values, want.edge_values)
    else:
        assert want.edge_values is None


@pytest.mark.parametrize("kind,short", [
    ("valued", False), ("pattern", False), ("comments", False),
    ("valued", True), ("comments", True)])
def test_parse_market_body_native_equals_jax_binding(port_lib, monkeypatch,
                                                     kind, short):
    """The JAX package's binding of ``gr_parse_market_body`` run over the
    port's library returns what the port's does: the same arrays, and
    None where ``nnz_max`` is below the body's line count."""
    _, body, lines, has_values = _market(kind)
    if kind == "comments":
        body, lines = _with_comment_lines(body, 4), lines + 5
    nnz_max = lines - 1 if short else lines
    got = tnative.parse_market_body_native(body, nnz_max, has_values)
    monkeypatch.setattr(jnative, "get_lib", lambda: port_lib)
    want = jnative.parse_market_body_native(body, nnz_max, has_values)
    if short:
        assert got is None and want is None
        return
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b)
