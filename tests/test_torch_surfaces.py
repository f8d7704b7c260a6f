"""The port's surfaces against the JAX package's: the C ABI's Python
bridge (``capi``) and its C shim, ``utils.track``, ``utils.modularity``,
``utils.baseline``, the ``convert`` tool's twin, ``io.rmat_device`` and
the composition example's twin.

Tolerances: labels, predecessors, components, distances and ids exact;
PageRank's ranks rtol 1e-4 / atol 2e-7 and BC rtol 1e-6 (the JAX
package's float32 sums against the port's float64 per-row sums, as in
``test_torch_pr.py`` and ``test_torch_bc.py``); modularity to 1e-12 (the
same float64 arithmetic); R-MAT quadrant shares within 0.005 of each
other and of a, b, c, d (about five standard deviations at 163,840 draws
a quadrant), since ``rmat_device`` matches the JAX package's
distribution, not its bits.
"""

import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu import capi as jcapi
from gunrock_tpu.utils import baseline as jbaseline
from gunrock_tpu.utils import track as jtrack
from gunrock_tpu.utils.modularity import modularity as jmodularity
from gunrock_tpu_torch import capi as tcapi
from gunrock_tpu_torch.tools import convert as tconvert
from gunrock_tpu_torch.utils import baseline as tbaseline
from gunrock_tpu_torch.utils import track as ttrack
from gunrock_tpu_torch.utils.modularity import modularity as tmodularity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The 7-vertex graph of tests/test_capi.py and examples/capi_example.c:
# two triangles bridged by one edge, and an isolated vertex.
ROW = np.array([0, 2, 4, 7, 10, 12, 14, 14], np.int32)
COL = np.array([1, 2, 0, 2, 0, 1, 3, 2, 4, 5, 3, 5, 3, 4], np.int32)
VAL = np.array([1, 4, 1, 1, 4, 1, 2, 2, 1, 4, 1, 1, 4, 1], np.float32)


def _both(name, make, *args, **kw):
    """Call ``<name>_c`` of both bridges on fresh output buffers made by
    ``make()``; returns ``(jax_buffers, port_buffers)``."""
    out = []
    for mod, extra in ((jcapi, {}), (tcapi, {"device": "cpu"})):
        bufs = make()
        ms = getattr(mod, name + "_c")(*[b.ctypes.data for b in bufs],
                                       *args, **extra, **kw)
        assert ms >= 0
        out.append(bufs)
    return out


def _graph_args():
    return (7, 14, ROW.ctypes.data, COL.ctypes.data)


@pytest.mark.parametrize("do", [False, True])
def test_capi_bfs_equals_jax(do):
    (jl, jp), (tl, tp) = _both(
        "bfs", lambda: (np.full(7, -9, np.int32), np.full(7, -9, np.int32)),
        *_graph_args(), 0, 1, int(do))
    np.testing.assert_array_equal(tl, [0, 1, 1, 2, 3, 3, -1])
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tp, jp)


def test_capi_cc_sssp_pagerank_bc_equal_jax():
    (jc, jn), (tc, tn) = _both(
        "cc", lambda: (np.zeros(7, np.int32), np.zeros(1, np.int32)),
        *_graph_args())
    assert tn[0] == jn[0] == 2
    np.testing.assert_array_equal(tc, jc)
    (jd, jp), (td, tp) = _both(
        "sssp", lambda: (np.zeros(7, np.float32), np.zeros(7, np.int32)),
        *_graph_args(), VAL.ctypes.data, 0, 1)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, jp)
    (ji, jr), (ti, tr) = _both(
        "pagerank", lambda: (np.zeros(7, np.int32),
                             np.zeros(7, np.float32)), *_graph_args(), 1)
    # the graph's symmetry ties ranks, which either side may order either
    # way: compare the rank of each vertex, and the order of the ranks
    np.testing.assert_array_equal(np.sort(ti), np.arange(7))
    by_vertex = [np.empty(7, np.float32) for _ in range(2)]
    by_vertex[0][ji], by_vertex[1][ti] = jr, tr
    np.testing.assert_allclose(by_vertex[1], by_vertex[0], rtol=1e-4,
                               atol=2e-7)
    assert (np.diff(tr) <= 1e-6).all()
    for source, want in ((0, [0, 0, 1.5, 1, 0, 0, 0]),
                         (-1, [0, 0, 6, 6, 0, 0, 0])):
        (jb,), (tb,) = _both("bc", lambda: (np.zeros(7, np.float32),),
                             *_graph_args(), source)
        np.testing.assert_allclose(tb, jb, rtol=1e-6)
        np.testing.assert_allclose(tb, want, rtol=1e-6)


def test_capi_bridge_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    labels = np.zeros(7, np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcapi.bfs_c(labels.ctypes.data, 0, *_graph_args(), 0, 0, 0)


def test_c_shim_builds_and_fails_without_a_card(tmp_path):
    """The shim builds with g++; the C consumer links it, and without a
    card the shim returns -1 (the JAX shim's failure code) and the
    consumer stops at its first call: nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: chip_smoke.py phase 30 runs it")
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no C/C++ compiler")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED") or not os.path.exists(
            os.path.join(sysconfig.get_paths()["include"], "Python.h")):
        pytest.skip("no shared libpython or Python headers to embed")
    so = tcapi.build_capi_lib()
    assert os.path.exists(so) and so.startswith(os.path.join(REPO, "build"))
    exe = str(tmp_path / "capi_example_torch")
    r = subprocess.run(
        ["gcc", os.path.join(REPO, "examples", "capi_example_torch.c"), "-o",
         exe, f"-I{tcapi.CAPI_HEADER_DIR}", so, "-lm"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert "CUDA is not available" in r.stderr and "cc failed" in r.stderr
    assert "ALL OK" not in r.stdout


def _jax_lines(capfd, *calls):
    for args, kw in calls:
        jtrack.track_values(*args, **kw)
    jax.effects_barrier()
    return capfd.readouterr().out.splitlines()


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_track_values_prints_the_jax_lines(capfd, dtype):
    values = np.arange(40).astype(dtype)
    if dtype == "float32":
        values /= np.float32(3)
    verts = [1, 5, 7, 39]
    calls = [(("dist", values, verts), {}),
             (("lab", values, verts), {"iteration": 4}),
             (("none", values, []), {})]
    want = _jax_lines(capfd, *[((n, jnp.asarray(v), vs), dict(kw))
                               for (n, v, vs), kw in calls])
    for (n, v, vs), kw in calls:
        ttrack.track_values(n, torch.from_numpy(v), vs, **kw)
    ttrack.track_values("lab", torch.from_numpy(values), verts,
                        iteration=torch.tensor(4))
    got = capfd.readouterr().out.splitlines()
    assert len(want) == 2
    assert got == want + [want[1]]


@pytest.mark.parametrize("rounds", [0, 1, 7, 40])
def test_inject_latency_bit_exact(rounds):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(100)
                         .astype(np.float32))
    before = x.clone()
    assert ttrack.inject_latency(x, rounds) is x
    assert torch.equal(x, before)
    np.testing.assert_array_equal(
        np.asarray(jtrack.inject_latency(jnp.asarray(before.numpy()),
                                         rounds)), before.numpy())

    def body(_, v):   # the JAX package's chain (utils/track.py)
        return (v * 1664525 + 1013904223) ^ (v >> 1)

    want = jax.lax.fori_loop(0, rounds, body,
                             jnp.full((8, 128), 12345, jnp.int32))
    np.testing.assert_array_equal(ttrack._burn(rounds, "cpu").numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_modularity_equals_jax(name):
    mods = {"jax": gt, "port": gtt}
    graphs = {}
    for k, m in mods.items():
        if name == "rmat":
            graphs[k] = m.io.rmat(scale=10, edge_factor=8, seed=4,
                                  undirected=True)
        else:
            idx = np.arange(32 * 32).reshape(32, 32)
            src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
            dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
            graphs[k] = m.from_coo(32 * 32, src, dst, undirected=True)
    n = graphs["port"].num_nodes
    rng = np.random.default_rng(6)
    comp = gtt.cc(graphs["port"], device="cpu").components
    for c in (np.zeros(n, np.int64), comp, rng.integers(0, 8, n),
              np.arange(n) // 64):
        want = jmodularity(graphs["jax"], c)
        assert abs(tmodularity(graphs["port"], c) - want) <= 1e-12
        assert abs(tmodularity(graphs["port"], torch.from_numpy(
            np.asarray(c))) - want) <= 1e-12
    assert tmodularity(gtt.from_coo(3, np.array([], np.int64),
                                    np.array([], np.int64)),
                       np.zeros(3, np.int64)) == 0.0


def test_baseline_equals_jax():
    assert tbaseline._ROWS == jbaseline._ROWS
    for prim in ("bfs", "sssp", "pr", "cc", "bc", "hits", "tc"):
        for kind in ("rmat", "market", "grid", "rgg", "meshy"):
            assert tbaseline.reference_row(prim, kind) == \
                jbaseline.reference_row(prim, kind)
            rec_t = tbaseline.annotate({"x": 1}, prim, kind, 1234.5)
            assert rec_t == jbaseline.annotate({"x": 1}, prim, kind, 1234.5)


def _jax_convert():
    spec = importlib.util.spec_from_file_location(
        "_jax_convert_tool", os.path.join(REPO, "tools", "convert.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    """A weighted Matrix Market file with duplicate edges and a self
    loop, made with numpy from a seed."""
    rng = np.random.default_rng(12)
    n, m = 300, 2500
    src, dst = rng.integers(1, n + 1, m), rng.integers(1, n + 1, m)
    w = rng.random(m).astype(np.float32) * 10
    path = tmp_path_factory.mktemp("convert") / "g.mtx"
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"% made from a seed\n{n} {n} {m}\n")
        for s, d, x in zip(src, dst, w):
            f.write(f"{s} {d} {x}\n")
    return str(path)


@pytest.mark.parametrize("steps", [
    [("mtx2bin", [])], [("mtx2bin", ["--undirected"])],
    [("mtx2bin", []), ("bin2mtx", [])],
    [("mtx2bin", ["--undirected"]), ("strip-weights", []), ("bin2mtx", [])],
    [("mtx2bin", []), ("add-weights", ["--seed", "3", "--lo", "1",
                                       "--hi", "9"])],
    [("bin2mtx", [])],
])
def test_convert_byte_identical(mtx, tmp_path, capsys, steps):
    """Each chain of commands, from the same .mtx, through the JAX tool
    and the port's twin: every file written and every line printed are
    byte for byte the same."""
    outs = {}
    for tool, main in (("jax", _jax_convert()), ("port", tconvert.main)):
        src, files = mtx, []
        for k, (cmd, flags) in enumerate(steps):
            dst = str(tmp_path / f"{tool}_{k}{'.mtx' if cmd == 'bin2mtx' else '.csr.npz'}")
            assert main([cmd, src, dst, *flags]) == 0
            files.append(open(dst, "rb").read())
            src = dst
        assert main(["info", src]) == 0
        text = capsys.readouterr().out.replace(str(tmp_path), "")
        outs[tool] = (files, text.replace(f"{tool}_", ""))
    assert outs["port"] == outs["jax"]


def test_convert_info_on_market(mtx, capsys):
    assert _jax_convert()(["info", mtx, "--undirected"]) == 0
    want = capsys.readouterr().out
    assert tconvert.main(["info", mtx, "--undirected"]) == 0
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("scale,edge_factor", [(10, 16), (7, 3)])
def test_rmat_device_on_the_cpu(scale, edge_factor):
    n, src, dst = gtt.io.rmat_device(scale, edge_factor, seed=5,
                                     device="cpu")
    e = int((1 << scale) * edge_factor)
    assert n == 1 << scale
    for t in (src, dst):
        assert t.dtype == torch.int32 and t.shape == (e,)
        assert t.device.type == "cpu"
        assert int(t.min()) >= 0 and int(t.max()) < n
    # one seed, one stream; another seed, other edges
    _, src2, dst2 = gtt.io.rmat_device(scale, edge_factor, seed=5,
                                       device="cpu")
    assert torch.equal(src, src2) and torch.equal(dst, dst2)
    assert not torch.equal(src, gtt.io.rmat_device(
        scale, edge_factor, seed=6, device="cpu")[1])


def _quadrant_shares(src, dst, scale):
    """Shares of the four quadrants over every level's bit pair."""
    bits = np.arange(scale)
    s = (np.asarray(src, np.int64)[:, None] >> bits) & 1
    d = (np.asarray(dst, np.int64)[:, None] >> bits) & 1
    q = (2 * s + d).ravel()
    return np.bincount(q, minlength=4) / q.size


def test_rmat_device_matches_the_distribution():
    """Quadrant shares of rmat_device against the host generator's
    (rmat_coo, the JAX package's numpy draws) and the JAX package's own
    rmat_device, and against a, b, c, d; and the degree profile."""
    scale, ef = 10, 16
    a, b, c = 0.57, 0.19, 0.19
    want = np.array([a, b, c, 1 - a - b - c])
    _, ts, td = gtt.io.rmat_device(scale, ef, seed=1, device="cpu")
    _, hs, hd = gtt.io.rmat_coo(scale, ef, seed=1)
    _, js, jd = gt.io.generators.rmat_device(scale, ef, seed=1)
    got = _quadrant_shares(ts.numpy(), td.numpy(), scale)
    for other in (_quadrant_shares(hs, hd, scale),
                  _quadrant_shares(np.asarray(js), np.asarray(jd), scale),
                  want):
        np.testing.assert_allclose(got, other, atol=0.005)
    # the same skew: the largest out-degree within 25% of the host's
    dev_deg = np.bincount(ts.numpy(), minlength=1 << scale)
    host_deg = np.bincount(hs, minlength=1 << scale)
    assert abs(dev_deg.max() / host_deg.max() - 1) < 0.25
    assert abs((dev_deg == 0).mean() - (host_deg == 0).mean()) < 0.05


def test_simple_example_twin_runs_on_the_cpu():
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "examples", "simple_example_torch.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = subprocess.run([sys.executable, os.path.join(
        REPO, "examples", "simple_example.py"), "no-such-file.mtx"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert want.returncode == 0, want.stderr

    def facts(text):   # the lines without their timings
        return [line.split(" (")[0] for line in text.splitlines()
                if line.startswith(("graph:", "cc:", "   largest", "bfs:",
                                    "bc:"))]

    assert facts(r.stdout) == facts(want.stdout)
