"""SSSP's value-carry deep micro-loop (``deep_carry``) of the PyTorch
port against the JAX package's ``deep_carry=True`` and against the
port's own ``deep_carry=False`` route, on a grid whose deep stretches
run many micro rounds and on R-MAT, in near-far and bellman mode.

Tolerances: none. Distances and predecessors are exact (every
relaxation rounds ``dist[u] + w`` as one float32 add on both sides),
and the iteration and edge counts are equal."""

import importlib

import numpy as np
import pytest

import gunrock_tpu as gt
import gunrock_tpu_torch as gtt

jsssp = importlib.import_module("gunrock_tpu.models.sssp")
tsssp = importlib.import_module("gunrock_tpu_torch.models.sssp")


def _grid(mod, n):
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return mod.from_coo(n * n, src, dst, undirected=True)


GRAPHS = {
    # 128 x 128: v_pad 16384, the least that holds the deep rung
    # (fcap >= 2 * DEEP_CAP), so the micro-loop runs its stretches
    "grid": lambda m: _grid(m, 128),
    "rmat": lambda m: m.io.rmat(scale=10, edge_factor=8, seed=42,
                                undirected=True),
}
_UPLOADS = {}


def _pair(name):
    if name not in _UPLOADS:
        gj, gp = GRAPHS[name](gt), GRAPHS[name](gtt)
        gj.random_edge_values(seed=11)
        gp.random_edge_values(seed=11)
        delta = 32.0 * float(np.mean(gp.edge_values))
        _UPLOADS[name] = (
            gt.to_device(gj, with_edge_values=True, with_csc=True),
            gtt.to_device(gp, with_edge_values=True, with_csc=True,
                          device="cpu"), delta)
    return _UPLOADS[name]


@pytest.mark.parametrize("name,mode", [("grid", "nearfar"),
                                       ("grid", "bellman"),
                                       ("rmat", "nearfar"),
                                       ("rmat", "bellman")])
def test_sssp_carry_equals_jax_and_the_plain_route(name, mode, monkeypatch):
    if name == "rmat":
        # v_pad 1024 is too small for the DEEP_CAP rung; both packages
        # read these smaller rungs, so their micro-loops run here too
        monkeypatch.setenv("GUNROCK_SSSP_DEEP_RUNGS", "64,256")
    dj, dp, delta = _pair(name)
    want, wpreds, wstats = jsssp.sssp_device(
        dj, 0, mark_preds=True, mode=mode, delta=delta, deep_carry=True)
    records = []
    got, preds, stats = tsssp.sssp_device(
        dp, 0, mark_preds=True, mode=mode, delta=delta, deep_carry=True,
        instrument=records)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(wpreds))
    assert stats.iteration == int(wstats.iteration)
    assert stats.edges_queued == float(wstats.edges_queued)
    phases = [r["phase"] for r in records]
    assert phases.count("deep") >= (100 if name == "grid" else 1)
    plain, ppreds, pstats = tsssp.sssp_device(
        dp, 0, mark_preds=True, mode=mode, delta=delta, deep_carry=False)
    assert plain.numpy().tobytes() == got.numpy().tobytes()
    np.testing.assert_array_equal(ppreds.numpy(), preds.numpy())
    assert (pstats.iteration, pstats.edges_queued, pstats.frontier_trace) \
        == (stats.iteration, stats.edges_queued, stats.frontier_trace)


@pytest.mark.parametrize("env", ["0", "1"])
def test_sssp_carry_env_is_honoured(env, monkeypatch):
    """``deep_carry=None`` reads ``GUNROCK_SSSP_CARRY`` (default off), in
    ``sssp_device`` and through ``sssp``; an explicit value wins."""
    _, dp, delta = _pair("grid")
    calls = []
    carry_round = tsssp._micro_round_carry

    def counted(*args):
        calls.append(1)
        return carry_round(*args)

    monkeypatch.setattr(tsssp, "_micro_round_carry", counted)
    monkeypatch.setenv("GUNROCK_SSSP_CARRY", env)
    tsssp.sssp_device(dp, 0, mode="nearfar", delta=delta)
    assert bool(calls) == (env == "1")
    calls.clear()
    tsssp.sssp_device(dp, 0, mode="nearfar", delta=delta,
                      deep_carry=env != "1")
    assert bool(calls) == (env != "1")
    calls.clear()
    g = GRAPHS["grid"](gtt)
    g.random_edge_values(seed=11)
    res = gtt.sssp(g, 0, mode="nearfar", device="cpu")
    assert bool(calls) == (env == "1")
    assert res.distances.tobytes() == \
        tsssp.sssp_device(dp, 0, mode="nearfar", delta=delta)[0][
            :dp.num_nodes].numpy().tobytes()
