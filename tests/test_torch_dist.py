"""The sharded zoo on a process group, one shard a rank (Gloo on the
CPU), against the stacked mesh and the JAX package.

The rank processes are ``gunrock_tpu_torch.tools.shard_ranks``, started
by its launcher with a free port (bound at port 0), an init timeout and
a deadline (a hang fails in seconds); they never import jax. One launch
a mesh size (p = 2 and 4) runs every entry point of ``RUNS`` on R-MAT
scale 9-10, the 32 x 32 grid and a path; the parent runs the same calls
on the stacked mesh (``make_mesh(p, device="cpu")``) and, at p = 4, BFS
and SSSP on the JAX package's 8 virtual CPU devices.

Tolerances: BFS, SSSP, CC, TopK, TC and the batches' labels are held
bitwise with every info field but the timings and the mesh's own
(``shard_ranks.comparable_info``); the floats at
``tests/test_torch_parallel.py``'s tolerances (PageRank rtol 1e-4, atol
2e-7; BC rtol 1e-4, atol 1e-4, sigma rtol 1e-5; HITS rtol 1e-4, atol
2e-5; SALSA rtol 1e-4, atol 1e-6; WTF's PPR rtol 1e-4, atol 1e-7 and
scores rtol 1e-4, atol 1e-9), with their info fields equal. Against the
JAX package: labels, predecessors, distances and the info fields
``tests/test_torch_parallel.py`` holds.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import gunrock_tpu as gt
import gunrock_tpu.parallel as JP
import gunrock_tpu_torch.parallel as TP
from gunrock_tpu_torch.tools import shard_ranks as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 120.0      # seconds a launch of every run may take
INIT_TIMEOUT = 30.0   # seconds a rank waits for the group

GRAPHS = {
    "r10": {"kind": "rmat", "scale": 10, "edge_factor": 8, "seed": 42,
            "undirected": True, "weights": None},
    "r9w": {"kind": "rmat", "scale": 9, "edge_factor": 8, "seed": 42,
            "undirected": True, "weights": 2},
    "grid": {"kind": "grid", "n": 32, "weights": 3},
    "path": {"kind": "path", "n": 300, "weights": None},
}

_BFS = dict(mark_preds=True, seed=3)
RUNS = {
    "bfs_push": ("bfs", "r10", 3, dict(_BFS)),
    "bfs_do": ("bfs", "r10", 3, dict(_BFS, direction_optimized=True,
                                      use_blocked=False)),
    "bfs_do_views": ("bfs", "r10", 3, dict(_BFS, direction_optimized=True,
                                            use_blocked=True)),
    "bfs_overflow": ("bfs", "r10", 0, dict(mark_preds=True,
                                           queue_sizing=0.01,
                                           in_sizing=0.01)),
    "bfs_do_overflow": ("bfs", "r10", 0, dict(direction_optimized=True,
                                              queue_sizing=0.05,
                                              in_sizing=0.05)),
    "bfs_grid": ("bfs", "grid", 0, dict(mark_preds=True,
                                        direction_optimized=True,
                                        partition_method="cluster")),
    "bfs_path": ("bfs", "path", 0, dict(mark_preds=True,
                                        partition_method="static")),
    "sssp_bellman": ("sssp", "r9w", 0, dict(mode="bellman", seed=1,
                                            use_blocked=False)),
    "sssp_nearfar": ("sssp", "r9w", 0, dict(mode="nearfar", seed=1,
                                            use_blocked=False)),
    "sssp_pull": ("sssp", "r9w", 0, dict(mode="bellman", seed=1,
                                         use_blocked=True, pull_frac=2)),
    "sssp_nearfar_pull": ("sssp", "r9w", 0, dict(mode="nearfar", seed=1,
                                                 use_blocked=True,
                                                 pull_frac=2)),
    "sssp_overflow": ("sssp", "r9w", 0, dict(mode="bellman",
                                             use_blocked=False,
                                             queue_sizing=0.02,
                                             in_sizing=0.02)),
    "sssp_grid": ("sssp", "grid", 0, dict(mode="nearfar", use_blocked=True,
                                          pull_frac=2,
                                          partition_method="cluster")),
    "pagerank": ("pagerank", "r10", None, dict(use_blocked=False)),
    "pagerank_views": ("pagerank", "r10", None, dict(
        use_blocked=True, partition_method="biasrandom")),
    "cc": ("cc", "r10", None, dict(partition_method="cluster")),
    "cc_path": ("cc", "path", None, dict(partition_method="static")),
    "bc": ("bc", "r10", 5, {}),
    "hits": ("hits", "r10", None, dict(max_iters=10)),
    "salsa": ("salsa", "r10", None, dict(max_iters=10,
                                         partition_method="static")),
    "wtf": ("wtf", "r10", 5, dict(seed=5)),
    "topk": ("topk", "r10", None, dict(k=7)),
    "tc": ("tc", "r10", None, {}),
    "bfs_batch": ("bfs_batch", "r10", [0, 5, 9, 11, 20], {}),
    "bc_batch": ("bc_batch", "r10", [0, 5, 9], {}),
}

# Exact arrays and the float ones' tolerances, by result field.
FLOAT_TOL = {
    ("pagerank", "ranks"): dict(rtol=1e-4, atol=2e-7),
    ("bc", "bc_values"): dict(rtol=1e-4, atol=1e-4),
    ("bc", "sigmas"): dict(rtol=1e-5, atol=0.0),
    ("bc_batch", "bc_values"): dict(rtol=1e-4, atol=1e-4),
    ("hits", "hubs"): dict(rtol=1e-4, atol=2e-5),
    ("hits", "auths"): dict(rtol=1e-4, atol=2e-5),
    ("salsa", "hubs"): dict(rtol=1e-4, atol=1e-6),
    ("salsa", "auths"): dict(rtol=1e-4, atol=1e-6),
    ("wtf", "ppr_ranks"): dict(rtol=1e-4, atol=1e-7),
    ("wtf", "scores"): dict(rtol=1e-4, atol=1e-9),
}


def _spec():
    runs = []
    for name, (prim, graph, src, kw) in RUNS.items():
        run = {"name": name, "prim": prim, "graph": graph, "kwargs": kw}
        if isinstance(src, list):
            run["sources"] = src
        elif src is not None:
            run["src"] = src
        runs.append(run)
    return {"graphs": GRAPHS, "runs": runs}


_CACHE = {}


def _graph(name):
    if name not in _CACHE:
        _CACHE[name] = R.build_graph(GRAPHS[name])
    return _CACHE[name]


def _stacked(name, p):
    """The stacked mesh's result of run ``name`` on ``p`` CPU shards."""
    key = ("stacked", name, p)
    if key not in _CACHE:
        prim, graph, src, kw = RUNS[name]
        args = (_graph(graph),) if src is None else (_graph(graph), src)
        _CACHE[key] = R._entry(prim)(*args, mesh=TP.make_mesh(p, device="cpu"),
                                     **kw)
    return _CACHE[key]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(p)``: every run of ``RUNS`` on ``p`` Gloo ranks on the
    CPU, launched once a ``p``; ``(records, arrays)``."""
    def get(p):
        if ("ranks", p) not in _CACHE:
            out = str(tmp_path_factory.mktemp(f"ranks{p}"))
            env = dict(os.environ, OMP_NUM_THREADS="1")
            _CACHE["ranks", p] = R.launch(
                _spec(), out, world=p, backend="gloo", device="cpu",
                deadline=DEADLINE, init_timeout=INIT_TIMEOUT, env=env)
        return _CACHE["ranks", p]
    return get


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", list(RUNS))
def test_process_group_equals_stacked_mesh(ranks, p, name):
    records, arrays = ranks(p)
    want = _stacked(name, p)
    prim = RUNS[name][0]
    got_info = records[0]["runs"][name]["info"]
    for field, val in vars(want).items():
        if not isinstance(val, np.ndarray):
            continue
        got = arrays[f"{name}/{field}"]
        assert got.dtype == val.dtype and got.shape == val.shape, field
        tol = FLOAT_TOL.get((prim, field))
        if tol is None:
            assert np.array_equal(got, val), field
        else:
            np.testing.assert_allclose(got, val, **tol)
    want_info = json.loads(json.dumps(R._jsonable(R.comparable_info(
        want.info))))
    got_info = R.comparable_info(got_info)
    assert got_info == want_info
    # every rank got the whole result: the same record on each
    for rec in records[1:]:
        assert R.comparable_info(rec["runs"][name]["info"]) == got_info


@pytest.mark.parametrize("p", [2, 4])
def test_process_group_mesh_fields(ranks, p):
    records, _ = ranks(p)
    for r, rec in enumerate(records):
        assert rec["rank"] == r and rec["world"] == p
        for name, run in rec["runs"].items():
            info = run["info"]
            assert info["backend"] == "gloo" and info["world_size"] == p
            assert info["rank_devices"] == ["cpu"] * p, name
            assert run["device"] == "cpu"


@pytest.mark.parametrize("p", [2, 4])
def test_collective_loop_ends_when_every_frontier_empties(ranks, p):
    """A path cut into contiguous shards (``static``): shard 0's frontier
    empties after the first levels while the others' are still to come,
    and the traversal still runs to the end on every rank."""
    records, arrays = ranks(p)
    n = GRAPHS["path"]["n"]
    assert np.array_equal(arrays["bfs_path/labels"], np.arange(n))
    for rec in records:
        assert rec["runs"]["bfs_path"]["info"]["num_iterations"] == n
        assert rec["runs"]["cc_path"]["info"]["num_components"] == 1


@pytest.mark.parametrize("p", [2, 4])
def test_overflow_retry_on_the_process_group(ranks, p):
    """The small sizings overflow the first attempt (shown on the
    stacked mesh's first attempt with the same sizing) and the
    collective retry ends with a complete run."""
    records, arrays = ranks(p)
    g = _graph("r10")
    pg, perm = TP.partition(g, p, device="cpu")
    first = TP.bfs_sharded_device(pg, int(perm[0]), mark_preds=True,
                                  queue_sizing=0.01, in_sizing=0.01)
    assert first[4]                                   # overflowed
    for name in ("bfs_overflow", "sssp_overflow"):
        for rec in records:
            assert not rec["runs"][name]["info"]["frontier_overflow"]
    assert np.array_equal(arrays["bfs_overflow/labels"],
                          _stacked("bfs_overflow", p).labels)


JAX_BFS_INFO = ("num_iterations", "direction_trace", "pull_iterations",
                "comm_bytes", "search_depth", "frontier_overflow",
                "blocked_kernels", "num_shards", "edges_visited")
JAX_SSSP_INFO = ("num_iterations", "comm_bytes", "frontier_overflow",
                 "delta", "edges_visited", "blocked_kernels")


def _jax_graph(name):
    key = ("jax", name)
    if key not in _CACHE:
        spec = GRAPHS[name]
        if spec["kind"] == "rmat":
            g = gt.io.rmat(scale=spec["scale"],
                           edge_factor=spec["edge_factor"],
                           seed=spec["seed"], undirected=True)
        else:
            n = spec["n"]
            idx = np.arange(n * n).reshape(n, n)
            src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
            dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
            g = gt.from_coo(n * n, src, dst, undirected=True)
        if spec.get("weights") is not None:
            g.random_edge_values(seed=spec["weights"])
        _CACHE[key] = g
    return _CACHE[key]


@pytest.mark.parametrize("name", ["bfs_push", "bfs_do", "bfs_do_views",
                                  "bfs_grid", "sssp_bellman", "sssp_nearfar",
                                  "sssp_nearfar_pull"])
def test_process_group_equals_jax_at_4(ranks, name):
    records, arrays = ranks(4)
    prim, graph, src, kw = RUNS[name]
    info = records[0]["runs"][name]["info"]
    gj = _jax_graph(graph)
    if prim == "bfs":
        want = JP.bfs_sharded(gj, src, num_shards=4, pallas_interpret=kw.get(
            "use_blocked", False), **kw)
        assert np.array_equal(arrays[f"{name}/labels"], want.labels)
        assert np.array_equal(arrays[f"{name}/preds"], want.preds)
        keys = JAX_BFS_INFO
    else:
        want = JP.sssp_sharded(gj, src, num_shards=4,
                               pallas_interpret=kw["use_blocked"], **kw)
        assert np.array_equal(arrays[f"{name}/distances"], want.distances)
        keys = JAX_SSSP_INFO
    for key in keys:
        assert info[key] == R._jsonable(want.info[key]), key


def test_make_mesh_names_the_process_group_route():
    with pytest.raises(NotImplementedError, match="process_group"):
        TP.make_mesh(device=["cpu", "meta"])
    m = TP.make_mesh(3, device="cpu")
    assert not m.distributed and m.local_shards == 3 and m.shard_lo == 0


def test_stacked_mesh_collectives():
    """The stacked mesh's collectives are the JAX package's over the
    leading axis: all_to_all a transpose, all_gather the tensor, the
    reductions over dim 0, read one row a shard, push the lanes as they
    are."""
    m = TP.make_mesh(3, device="cpu")
    x = torch.arange(3 * 3 * 2).view(3, 3, 2)
    assert torch.equal(m.all_to_all(x), x.transpose(0, 1))
    y = torch.rand(3, 5)
    assert m.all_gather(y) is y
    assert torch.equal(m.psum(y), y.sum(dim=0))
    assert torch.equal(m.pmax(y), y.amax(dim=0))
    assert torch.equal(m.pmin(y), y.amin(dim=0))
    assert torch.equal(m.axis_index(), torch.arange(3))
    assert m.read([[1, 2], [3, 4], [5, 6]]) == [[1, 2], [3, 4], [5, 6]]
    assert m.read(torch.ones(3, 1, dtype=torch.int64)) == [[1]] * 3
    lanes = torch.arange(7)
    assert torch.equal(m.push(lanes % 3, [lanes])[0], lanes)
    assert m.local(y) is y


def test_partition_shard_and_from_numpy_shard():
    """A rank's shard: row i of every stacked array and producer i's
    ghost tables, from a port partition (``shard``) and from its fields
    (``from_numpy(shard=i)``)."""
    g = _graph("r10")
    pg, _ = TP.partition(g, 4, with_csc=True, with_ghosts=True,
                         with_edge_values=True, device="cpu")
    fields = {k: (v.numpy() if torch.is_tensor(v) else v)
              for k, v in vars(pg).items()}
    for i in range(4):
        for got in (pg.shard(i), TP.PartitionedGraph.from_numpy(
                fields, "cpu", shard=i)):
            assert got.shard_lo == i and got.local_shards == 1
            assert got.num_shards == 4
            assert torch.equal(got.csc_local[0], pg.csc_local[i])
            assert torch.equal(got.ghost_send_idx[0], pg.ghost_send_idx[i])
            assert torch.equal(got.fwd_ghost_send_idx[0],
                               pg.fwd_ghost_send_idx[i])
    with pytest.raises(ValueError, match="process-group mesh"):
        TP.bfs_sharded_device(pg.shard(1), 0)


@pytest.mark.parametrize("how", ["replace", "copy", "pickle"])
def test_shard_lo_survives_replace_copy_and_pickle(how):
    """The shard a rank holds is a field of its partition: a copy made
    by ``dataclasses.replace``, ``copy.copy`` or a pickle round trip
    still holds that shard, and runs only on its rank's mesh."""
    import copy
    import dataclasses
    import pickle
    pg, _ = TP.partition(_graph("r10"), 4, device="cpu")
    one = pg.shard(1)
    got = {"replace": lambda: dataclasses.replace(one),
           "copy": lambda: copy.copy(one),
           "pickle": lambda: pickle.loads(pickle.dumps(one))}[how]()
    assert got.shard_lo == 1 and got.local_shards == 1
    assert torch.equal(got.row_offsets, pg.row_offsets[1:2])
    with pytest.raises(ValueError, match="process-group mesh"):
        TP.bfs_sharded_device(got, 0)


@pytest.mark.parametrize("prim", ["bfs", "sssp"])
def test_torchrun_cli_matches_jax_cli(prim, capsys, tmp_path):
    """``python -m torch.distributed.run --nproc-per-node=2 -m
    gunrock_tpu_torch <prim> ... --num-shards=2`` (Gloo on the CPU):
    rank 0 alone prints, the same validation line and Info fields as the
    JAX CLI on the same argv."""
    from gunrock_tpu import cli as jax_cli
    argv = {"bfs": ["bfs", "rmat", "--rmat_scale=8", "--num-shards=2",
                    "--mark-pred", "--src=3"],
            "sssp": ["sssp", "rmat", "--rmat_scale=8", "--num-shards=2",
                     "--mode=nearfar", "--random-edge-values",
                     "--rmat_seed=3"]}[prim]
    jout = tmp_path / "jax.json"
    assert jax_cli.main(argv + [f"--jsonfile={jout}"]) == 0
    jlines = [line for line in capsys.readouterr().out.splitlines()
              if "validation:" in line]
    tout = tmp_path / "port.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    # A session of its own, so that a hang kills the launcher's workers
    # too.
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "gunrock_tpu_torch", *argv,
         "--device=cpu", f"--jsonfile={tout}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    lines = [line for line in out.splitlines() if "validation:" in line]
    assert lines == jlines == [f"{prim} validation: CORRECT"]
    want, got = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert got["primitive"] == want["primitive"]
    assert got["backend"] == "gloo" and got["world_size"] == 2
    for key in ("num_shards", "search_depth", "partition_method",
                "num_iterations", "comm_bytes"):
        if key in want:
            assert got[key] == want[key], key
