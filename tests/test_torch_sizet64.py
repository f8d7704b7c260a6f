"""64-bit edge offsets (``sizet64``) in the PyTorch port against the JAX
package in its x64 mode.

One subprocess per module runs the JAX package with ``JAX_ENABLE_X64=1``
on the CPU (as ``tests/test_graph.py::test_sizet64_offsets_oracle`` does,
its Pallas kernels off as they are off the TPU) on an R-MAT graph
uploaded with ``sizet64=True``, and writes ``np.asarray`` of the graph's
fields and every primitive's results to an ``.npz``. The port loads
those fields through ``from_numpy`` and runs the same primitives.

Tolerances: labels, predecessors, distances, components, ids and counts
are exact; the float sums those of the existing parity tests (sigma
rtol 1e-5, BC rtol 1e-4 / atol 1e-4 as in ``test_torch_bc.py``; HITS and
SALSA ``LINK_TOL`` of ``test_torch_pr.py``; PageRank's loop route rtol
5e-3 / atol 1e-9 as in ``test_pagerank_device_routes_equal_jax``, the JAX
package's float32 running sums against the port's per-row float64). The port against itself,
sizet64 against int32 offsets on one graph, is bitwise.

The JAX package's PageRank raises ``TypeError`` in x64 mode whatever the
offsets' width (its loop carries an int32 count that ``jnp.sum`` widens
to int64 there): so it cannot run on any sizet64 graph, and the port's
PageRank on one is held to the JAX package's outside x64 mode instead.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt
from gunrock_tpu_torch.graph import device as D
from gunrock_tpu_torch.models.bc import bc_device
from gunrock_tpu_torch.models.cc import cc_device
from gunrock_tpu_torch.models.hits import hits_device
from gunrock_tpu_torch.models.pr import pagerank_device
from gunrock_tpu_torch.models.salsa import salsa_device
from gunrock_tpu_torch.models.sssp import sssp_device
from gunrock_tpu_torch.models.topk import topk_device
from gunrock_tpu_torch.models.wtf import wtf_device
from gunrock_tpu_torch.ops import kernels as K
from test_torch_pr import LINK_TOL

# the package's models/__init__ rebinds "bfs" to the function
tbfs = importlib.import_module("gunrock_tpu_torch.models.bfs")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("row_offsets", "col_indices", "edge_values", "edge_src",
          "csc_offsets", "csc_indices", "csc_edge_values", "csc_edge_dst")
# R-MAT scale 10, edge factor 8, seed 5, undirected, weights seed 7: the
# graph of both sides.
GRAPH = dict(scale=10, edge_factor=8, seed=5, undirected=True)

JAX_X64 = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
import numpy as np
import gunrock_tpu as gt
from gunrock_tpu.models.bc import bc_device
from gunrock_tpu.models.bfs import bfs_device
from gunrock_tpu.models.cc import cc_device
from gunrock_tpu.models.hits import hits_device
from gunrock_tpu.models.pr import pagerank_device
from gunrock_tpu.models.salsa import salsa_device
from gunrock_tpu.models.sample import sample
from gunrock_tpu.models.sssp import sssp_device
from gunrock_tpu.models.topk import topk_device

g = gt.io.rmat(**GRAPH)
g.random_edge_values(seed=7)
dg = gt.to_device(g, with_csc=True, with_edge_values=True,
                  with_edge_src=True, sizet64=True)
src = int(np.argmax(np.diff(g.row_offsets)))
out = {f: np.asarray(getattr(dg, f)) for f in FIELDS}
out.update(num_nodes=dg.num_nodes, num_edges=dg.num_edges, v_pad=dg.v_pad,
           e_pad=dg.e_pad, src=src)
a = np.asarray
for name, do in (("bfs_do", True), ("bfs", False)):
    lab, pred = bfs_device(dg, src, mark_preds=True,
                           direction_optimized=do)[:2]
    out[name + "_labels"], out[name + "_preds"] = a(lab), a(pred)
for mode in ("nearfar", "bellman"):
    dist, pred = sssp_device(dg, src, mark_preds=True, mode=mode)[:2]
    out["sssp_" + mode + "_dist"], out["sssp_" + mode + "_preds"] = \
        a(dist), a(pred)
comp, ncomp = cc_device(dg)[:2]
out["cc_comp"], out["cc_num"] = a(comp), int(ncomp)
bcv, sigma, labels = bc_device(dg, src)[:3]
out["bc_bc"], out["bc_sigma"], out["bc_labels"] = a(bcv), a(sigma), a(labels)
hub, auth = hits_device(dg)[:2]
out["hits_hub"], out["hits_auth"] = a(hub), a(auth)
hub, auth = salsa_device(dg)[:2]
out["salsa_hub"], out["salsa_auth"] = a(hub), a(auth)
ids, cent = topk_device(dg, 50)[:2]
out["topk_ids"], out["topk_cent"] = a(ids), a(cent)
out["sample"] = sample(dg, src)
for tag, s64 in (("pr_raises_64", True), ("pr_raises_32", False)):
    try:
        pagerank_device(gt.to_device(g, with_csc=True, sizet64=s64))
        out[tag] = ""
    except Exception as e:
        out[tag] = type(e).__name__
for flag in ("with_blocked_csc", "with_blocked_values"):
    try:
        gt.to_device(g, with_csc=True, sizet64=True, **{flag: True})
        out["raises_" + flag] = ""
    except Exception as e:
        out["raises_" + flag] = type(e).__name__
np.savez(sys.argv[2], **out)
print("OK")
""".replace("FIELDS", repr(FIELDS)).replace("GRAPH", f"dict(**{GRAPH!r})")


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    """The JAX package's sizet64 graph and results, from one x64
    subprocess (about 15 s) for the module."""
    path = str(tmp_path_factory.mktemp("sizet64") / "jax64.npz")
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_X64, ROOT, path],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert "OK" in out.stdout, out.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def graph64(jax64):
    """The JAX graph's fields loaded into the port, on the CPU."""
    return D.from_numpy({f: jax64[f] for f in FIELDS},
                        **_sizes(jax64), device="cpu")


@pytest.fixture(scope="module")
def graph32(jax64):
    """The same graph with int32 offsets."""
    fields = {f: jax64[f].astype(np.int32) if f.endswith("offsets")
              else jax64[f] for f in FIELDS}
    g = D.from_numpy(fields, **_sizes(jax64), device="cpu")
    assert not g.sizet64
    return g


def _sizes(z):
    return {k: int(z[k]) for k in ("num_nodes", "num_edges", "v_pad",
                                   "e_pad")}


def test_jax_sizet64_fields_load_unchanged(jax64, graph64):
    assert graph64.sizet64
    for f in FIELDS:
        got = getattr(graph64, f).numpy()
        want = jax64[f]
        assert got.dtype == want.dtype, f
        assert want.dtype == (np.int64 if f.endswith("offsets") else
                              np.float32 if "values" in f else np.int32), f
        np.testing.assert_array_equal(got, want)
    assert graph64.out_degrees().dtype == torch.int64
    assert not graph64.has_pull2 and not graph64.has_blocked_csc


def _run(name, g, src):
    """One primitive of the port on ``g``: its outputs by key."""
    if name in ("bfs_do", "bfs"):
        lab, pred = tbfs.bfs_device(g, src, mark_preds=True,
                                    direction_optimized=name == "bfs_do")[:2]
        return {"labels": lab, "preds": pred}
    if name.startswith("sssp_"):
        dist, pred = sssp_device(g, src, mark_preds=True,
                                 mode=name[len("sssp_"):])[:2]
        return {"dist": dist, "preds": pred}
    if name == "cc":
        comp, num = cc_device(g)[:2]
        return {"comp": comp, "num": torch.tensor(num)}
    if name == "bc":
        bcv, sigma, labels = bc_device(g, src)[:3]
        return {"bc": bcv, "sigma": sigma, "labels": labels}
    if name in ("hits", "salsa"):
        hub, auth = (hits_device if name == "hits" else salsa_device)(g)[:2]
        return {"hub": hub, "auth": auth}
    if name == "topk":
        ids, cent = topk_device(g, 50)[:2]
        return {"ids": ids, "cent": cent}
    if name == "sample":
        return {"": torch.from_numpy(gtt.sample(g, src, device="cpu"))}
    raise ValueError(name)


TOL = {"bc_sigma": dict(rtol=1e-5), "bc_bc": dict(rtol=1e-4, atol=1e-4),
       **{f"{p}_{k}": LINK_TOL[p] for p in ("hits", "salsa")
          for k in ("hub", "auth")}}
PRIMITIVES = ("bfs_do", "bfs", "sssp_nearfar", "sssp_bellman", "cc", "bc",
              "hits", "salsa", "topk", "sample")


@pytest.mark.parametrize("name", PRIMITIVES)
def test_sizet64_primitive_equals_jax_x64(jax64, graph64, name):
    src = int(jax64["src"])
    for key, got in _run(name, graph64, src).items():
        tag = f"{name}_{key}" if key else name
        want = jax64[tag]
        got = got.numpy()
        if tag in TOL:
            np.testing.assert_allclose(got, want, **TOL[tag])
        else:
            np.testing.assert_array_equal(got, want, err_msg=tag)


@pytest.mark.parametrize("name", PRIMITIVES + ("pagerank", "wtf",
                                               "sssp_fused"))
def test_sizet64_equals_int32_offsets_bitwise(jax64, graph64, graph32,
                                              name):
    """The same routes on the same graph: wide offsets change no bit."""
    src = int(jax64["src"])

    def run(g):
        if name == "pagerank":
            return dict(zip(("rank", "order"), pagerank_device(g)[:2]))
        if name == "wtf":
            return dict(zip(("ids", "scores", "ppr"),
                            wtf_device(g, src)[:3]))
        if name == "sssp_fused":
            return dict(zip(("dist", "preds"), sssp_device(
                g, src, mark_preds=True, mode="nearfar", fused=True)[:2]))
        return _run(name, g, src)

    want, got = run(graph32), run(graph64)
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_pagerank_raises_in_jax_x64_and_runs_on_sizet64(jax64, graph64):
    """The JAX package's PageRank fails in x64 mode with 32-bit offsets
    too, so the fault is its x64 mode's, not a rule of sizet64: the port
    runs PageRank on the sizet64 graph and is held to the JAX package's
    run outside x64 mode on the same graph."""
    assert jax64["pr_raises_64"] == "TypeError"
    assert jax64["pr_raises_32"] == "TypeError"
    g = gt.io.rmat(**GRAPH)
    want = gt.pagerank(g)
    got = gtt.pagerank(graph64, device="cpu")
    np.testing.assert_allclose(got.ranks, want.ranks, rtol=5e-3, atol=1e-9)


@pytest.mark.parametrize("flag", ["with_blocked_csc", "with_blocked_values"])
def test_blocked_flags_refused_with_sizet64(jax64, flag):
    assert jax64["raises_" + flag] == "ValueError"
    g = gtt.io.rmat(scale=8, edge_factor=4, seed=1)
    with pytest.raises(ValueError, match="32-bit offsets"):
        gtt.to_device(g, sizet64=True, device="cpu", **{flag: True})
    fields = D._host_fields(g, g.csc(), D._pad(g.num_nodes),
                            D._pad(g.num_edges), with_edge_values=False,
                            with_edge_src=False, off_dtype=np.int64)
    with pytest.raises(ValueError, match="32-bit offsets"):
        D.from_numpy(fields, num_nodes=g.num_nodes, num_edges=g.num_edges,
                     v_pad=D._pad(g.num_nodes), e_pad=D._pad(g.num_edges),
                     device="cpu", **{flag: True})
    # without them the same arrays load with 64-bit offsets
    dg = D.from_numpy(fields, num_nodes=g.num_nodes, num_edges=g.num_edges,
                      v_pad=D._pad(g.num_nodes), e_pad=D._pad(g.num_edges),
                      device="cpu")
    assert dg.row_offsets.dtype == dg.csc_offsets.dtype == torch.int64


def test_sizet64_rule_at_the_boundary(monkeypatch):
    """``None`` turns 64-bit offsets on at ``e_pad >= 2**31 - 2``: the
    rule at the real bound, through ``_pad``, and through ``to_device``
    and ``from_numpy`` with the bound lowered (no 2^31 array is made)."""
    assert D.SIZET64_EDGES == 2**31 - 2
    assert not D.sizet64_rule(2**31 - 3, None)
    assert D.sizet64_rule(2**31 - 2, None)
    # _pad rounds edge counts to 8192 from 8192 on: the last count below
    # the bound pads to 2^31 - 8192, the next one to 2^31.
    assert D._pad(2**31 - 8192) == 2**31 - 8192
    assert not D.sizet64_rule(D._pad(2**31 - 8192), None)
    assert D._pad(2**31 - 8191) == 2**31
    assert D.sizet64_rule(D._pad(2**31 - 8191), None)
    assert not D.sizet64_rule(2**40, False)
    assert D.sizet64_rule(128, True)
    g = gtt.io.rmat(scale=9, edge_factor=8, seed=3)   # e_pad 8192 or more
    e_pad = D._pad(g.num_edges)
    monkeypatch.setattr(D, "SIZET64_EDGES", e_pad)
    assert gtt.to_device(g, with_csc=True, device="cpu").sizet64
    with pytest.raises(ValueError, match="32-bit offsets"):
        gtt.to_device(g, with_blocked_csc=True, device="cpu")
    assert not gtt.to_device(g, sizet64=False, device="cpu").sizet64
    monkeypatch.setattr(D, "SIZET64_EDGES", e_pad + 1)
    dg = gtt.to_device(g, with_csc=True, device="cpu")
    assert dg.row_offsets.dtype == dg.csc_offsets.dtype == torch.int32
    fields = {f: getattr(dg, f).numpy() for f in ("row_offsets",
                                                  "col_indices")}
    sizes = dict(num_nodes=dg.num_nodes, num_edges=dg.num_edges,
                 v_pad=dg.v_pad, e_pad=dg.e_pad, device="cpu")
    assert not D.from_numpy(fields, **sizes).sizet64
    monkeypatch.setattr(D, "SIZET64_EDGES", e_pad)
    assert D.from_numpy(fields, **sizes).sizet64


def test_offsets_given_int64_and_timings():
    """``from_numpy`` keeps int64 offsets given as int64 and narrows them
    when asked ``sizet64=False``; ``timings`` reports its two steps."""
    g = gtt.io.rmat(scale=8, edge_factor=4, seed=2)
    d32 = gtt.to_device(g, device="cpu")
    fields = {"row_offsets": d32.row_offsets.numpy().astype(np.int64),
              "col_indices": d32.col_indices.numpy()}
    sizes = dict(num_nodes=d32.num_nodes, num_edges=d32.num_edges,
                 v_pad=d32.v_pad, e_pad=d32.e_pad, device="cpu")
    t = {}
    wide = D.from_numpy(fields, timings=t, **sizes)
    assert wide.sizet64 and set(t) == {"check_s", "upload_s"}
    narrow = D.from_numpy(fields, sizet64=False, **sizes)
    assert torch.equal(narrow.row_offsets, d32.row_offsets)
    # the host arrays are copied, never shared
    fields["row_offsets"][1] += 1
    assert int(wide.row_offsets[1]) == int(d32.row_offsets[1])


def test_api_takes_int64_offsets_unchanged():
    g = gtt.io.rmat(scale=9, edge_factor=8, seed=4, undirected=True)
    off64 = g.row_offsets.astype(np.int64)
    for off in (off64, off64.astype(np.int32)):
        labels = gtt.api.bfs(g.num_nodes, off, g.col_indices, src=1,
                             device="cpu")
        np.testing.assert_array_equal(
            labels, gtt.bfs(g, 1, device="cpu").labels)
        comp, num = gtt.api.cc(g.num_nodes, off, g.col_indices,
                               device="cpu")
        want = gtt.cc(g, device="cpu")
        np.testing.assert_array_equal(comp, want.components)
        assert num == want.num_components


def test_k10_plain_wraps_past_2_31_hits():
    """K10's sums are int32 modulo 2^32 (``bitmask_gather_cumsum_plain``
    with ``start`` near 2^31 stands for the ids before a stream's tail):
    the sums wrap, and a row's count, the difference of its bounds' sums
    taken modulo 2^32, stays exact, so BFS's pull reads it right."""
    rng = np.random.default_rng(11)
    words = K.pack_bitmask(torch.from_numpy(rng.random(4096) < 0.5))
    idx = torch.from_numpy(rng.integers(0, 4096, 50000).astype(np.int32))
    start = 2**31 - 7000
    got = K.bitmask_gather_cumsum_plain(words, idx, start=start)
    bits = K.bitmask_gather_plain(words, idx).numpy().astype(np.int64)
    exact = start + np.cumsum(bits)
    assert exact[-1] > 2**31 and exact[0] < 2**31   # the sums cross 2^31
    want = ((exact + 2**31) % 2**32 - 2**31).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and (got.numpy() < 0).any()
    # rows of 0 to 60 ids: counts from the wrapped sums equal the true ones
    bounds = np.unique(np.r_[0, np.sort(rng.integers(0, 50000, 1500)),
                             50000])
    s = np.r_[np.int64(start), exact][bounds]
    w = np.r_[np.int32(start), got.numpy()][bounds].astype(np.int64)
    np.testing.assert_array_equal((w[1:] - w[:-1]) % 2**32, s[1:] - s[:-1])
    np.testing.assert_array_equal(w[1:] != w[:-1], s[1:] > s[:-1])
    # chunks carried by start join into the whole stream
    a = K.bitmask_gather_cumsum_plain(words, idx[:20000], start=start)
    b = K.bitmask_gather_cumsum_plain(words, idx[20000:],
                                      start=int(a[-1]))
    np.testing.assert_array_equal(torch.cat([a, b]).numpy(), want)


def test_do_bfs_pull_reads_wrapped_sums(monkeypatch):
    """DO-BFS with K10's sums shifted to wrap past 2^31 mid-stream gives
    the same labels and predecessors."""
    g = gtt.io.rmat(scale=11, edge_factor=16, seed=9, undirected=True)
    dg = gtt.to_device(g, with_csc=True, device="cpu")
    records = []
    want = tbfs.bfs_device(dg, 3, mark_preds=True, direction_optimized=True,
                           instrument=records)
    assert any(r["pull"] for r in records)

    def wrapped(words, idx):
        out = K.bitmask_gather_cumsum_plain(words, idx, start=2**31 - 5)
        assert (out < 0).any()   # past 2^31
        return out

    monkeypatch.setattr(tbfs, "bitmask_gather_cumsum", wrapped)
    got = tbfs.bfs_device(dg, 3, mark_preds=True, direction_optimized=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("chunk", [7, 1000, 1 << 24])
def test_fill_preds_in_chunks(jax64, graph64, monkeypatch, chunk):
    """The predecessor fills walk the CSC in chunks of ``HIT_CHUNK``
    edges with the running max carried across: any chunk gives the JAX
    package's predecessors."""
    monkeypatch.setattr(K, "HIT_CHUNK", chunk)
    src = int(jax64["src"])
    got = _run("bfs_do", graph64, src)["preds"]
    np.testing.assert_array_equal(got.numpy(), jax64["bfs_do_preds"])
    got = _run("sssp_nearfar", graph64, src)["preds"]
    np.testing.assert_array_equal(got.numpy(), jax64["sssp_nearfar_preds"])


def test_row_bounds32_narrows_and_refuses(graph64, graph32):
    """The CSC-tile kernels' int32 row bounds: narrowed exactly on a
    sizet64 graph below 2^31 edges, refused past it."""
    assert K.row_bounds32(graph32) is graph32.csc_offsets
    got = K.row_bounds32(graph64)
    assert got.dtype == torch.int32
    assert torch.equal(got, graph32.csc_offsets)
    big = dataclasses.replace(graph64, num_edges=2**31)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        K.row_bounds32(big)


def test_tc_dag_offsets_by_the_rule(monkeypatch):
    """TC's oriented DAG takes 64-bit offsets by the sizet64 rule (the
    bound lowered here): the same counts as with int32 offsets and as
    the JAX package's."""
    ttc = importlib.import_module("gunrock_tpu_torch.models.tc")
    g = gtt.io.rmat(scale=9, edge_factor=8, seed=2, undirected=True)
    want = gt.tc(gt.io.rmat(scale=9, edge_factor=8, seed=2,
                            undirected=True))
    assert ttc._tc_prepare(g).row.dtype == np.int32
    narrow = gtt.tc(g, device="cpu")
    monkeypatch.setattr(D, "SIZET64_EDGES", 1)
    assert ttc._tc_prepare(g).row.dtype == np.int64
    wide = gtt.tc(g, device="cpu")
    assert wide.total == narrow.total == want.total
    np.testing.assert_array_equal(wide.vertex_counts, narrow.vertex_counts)
    np.testing.assert_array_equal(wide.edge_counts, narrow.edge_counts)
