"""Run the sharded primitives on a process group, one shard a rank.

The launcher (:func:`launch`) starts ``world`` processes of this module,
each a rank of one ``torch.distributed`` group (``tcp://127.0.0.1`` at
a port found by binding port 0, an init timeout), waits for them with a
deadline, and fails if a rank fails or the deadline passes, killing the
others, so a hang costs seconds. Every rank builds the graphs of a spec,
makes the process-group mesh (``parallel.make_mesh``) and runs each of
the spec's entry points (``bfs_sharded``, ``sssp_sharded``, ...) on it;
every rank gets the whole result back, and rank 0 writes the arrays.

A spec is a JSON object::

    {"graphs": {"<name>": {"kind": "rmat", "scale": 9, "edge_factor": 8,
                           "seed": 42, "undirected": true, "weights": 2}
                          | {"kind": "grid", "n": 32, "weights": null}
                          | {"kind": "path", "n": 1000}
                          | {"kind": "npz", "path": "...",
                             "undirected": true}},
     "runs": [{"name": "<run>", "prim": "bfs", "graph": "<name>",
               "src": 3, "kwargs": {...}}, ...]}

``prim`` names a ``gunrock_tpu_torch.parallel`` entry point without its
``_sharded`` suffix (``bfs_batch`` and ``bc_batch`` as they are). Each
rank writes ``rank<r>.json`` (per run: the kernel launches, the wall and
process times, the info record, the device); rank 0 also writes
``arrays.npz`` (``<run>/<field>``). The kernel library, where the ranks
run on a card, is built by the launching process before the ranks start
(:func:`launch` with ``build=True``), so the ranks only load it.

Run a rank by hand (the launcher does this)::

    python -m gunrock_tpu_torch.tools.shard_ranks --spec spec.json \
        --out DIR --rank 0 --world 2 --port 29500 --backend gloo \
        --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import numpy as np

__all__ = ["launch", "free_port", "build_graph", "TIMING_KEYS",
           "comparable_info"]

# Info fields that differ between runs or meshes by nature: timings, the
# record's context, the device and the process-group mesh's own fields.
TIMING_KEYS = ("time", "command_line", "m_teps", "gpuinfo", "sysinfo",
               "git_commit_sha1", "backend", "world_size", "rank_devices")


def comparable_info(info: dict) -> dict:
    """``info`` without its timings and mesh fields: what two meshes
    running one primitive must agree on."""
    return {k: v for k, v in info.items()
            if k not in TIMING_KEYS and not k.endswith("_ms")}


def free_port() -> int:
    """A free TCP port on the loopback interface (bind port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_graph(spec: dict):
    """A host graph from one ``graphs`` entry of a spec."""
    import gunrock_tpu_torch as gtt
    kind = spec["kind"]
    if kind == "rmat":
        g = gtt.io.rmat(scale=spec["scale"], edge_factor=spec["edge_factor"],
                        seed=spec["seed"],
                        undirected=spec.get("undirected", True))
    elif kind in ("grid", "path"):
        n = spec["n"]
        if kind == "grid":
            idx = np.arange(n * n).reshape(n, n)
            src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
            dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
            n = n * n
        else:
            src, dst = np.arange(n - 1), np.arange(1, n)
        g = gtt.from_coo(n, src, dst, undirected=True)
    elif kind == "npz":
        from gunrock_tpu_torch.graph.csr import CsrGraph
        with np.load(spec["path"]) as f:
            g = CsrGraph(num_nodes=int(f["row_offsets"].shape[0] - 1),
                         row_offsets=f["row_offsets"],
                         col_indices=f["col_indices"],
                         edge_values=f["edge_values"]
                         if "edge_values" in f else None,
                         undirected=spec.get("undirected", True))
    else:
        raise ValueError(f"unknown graph kind {kind!r}")
    if spec.get("weights") is not None:
        g.random_edge_values(seed=spec["weights"])
    return g


def _entry(prim: str):
    from gunrock_tpu_torch import parallel as SP
    if prim in ("bfs_batch", "bc_batch"):
        return getattr(SP, prim)
    return getattr(SP, f"{prim}_sharded")


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def run_rank(spec: dict, out: str, *, rank: int, world: int, port: int,
             backend: str, device: str, init_timeout: float) -> None:
    """One rank: join the group, run every run of ``spec``, write the
    results."""
    import torch
    import torch.distributed as dist
    from gunrock_tpu_torch import parallel as SP
    from gunrock_tpu_torch.ops import kernels as K

    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=init_timeout))
    try:
        mesh = SP.make_mesh(device=device)
        dev = mesh.device
        graphs = {name: build_graph(g) for name, g in spec["graphs"].items()}
        records, arrays = {}, {}
        for run in spec["runs"]:
            g = graphs[run["graph"]]
            args = (g,) if "src" not in run else (g, run["src"])
            if "sources" in run:
                args = (g, run["sources"])
            K.reset_launch_counts()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = _entry(run["prim"])(*args, mesh=mesh,
                                      **run.get("kwargs", {}))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3
            records[run["name"]] = {
                "launches": {k: v for k, v in K.LAUNCHES.items() if v},
                "wall_ms": wall, "info": _jsonable(res.info),
                "device": str(dev)}
            for f in dataclasses.fields(res):
                val = getattr(res, f.name)
                if isinstance(val, np.ndarray):
                    arrays[f"{run['name']}/{f.name}"] = val
                elif f.name == "total":
                    arrays[f"{run['name']}/{f.name}"] = np.asarray(val)
        if rank == 0:
            np.savez(os.path.join(out, "arrays.npz"), **arrays)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "world": world, "backend": backend,
                       "runs": records}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tail(out: str, rank: int) -> str:
    with open(os.path.join(out, f"rank{rank}.log")) as f:
        return f.read()[-4000:]


def launch(spec: dict, out: str, *, world: int, backend: str,
           device: str, deadline: float = 120.0, init_timeout: float = 60.0,
           build: bool = False, env: Optional[dict] = None):
    """Run ``spec`` on ``world`` ranks; returns ``(records, arrays)``:
    each rank's JSON record and rank 0's arrays. ``build``: build the
    kernel library here first, so the ranks only load it. Raises
    ``TimeoutError`` past ``deadline`` seconds (every rank killed) and
    ``RuntimeError`` when a rank fails."""
    if build:
        from gunrock_tpu_torch.ops import _build
        _build.build()
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    penv = dict(os.environ if env is None else env)
    penv["PYTHONPATH"] = root + os.pathsep + penv.get("PYTHONPATH", "")
    logs = [open(os.path.join(out, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gunrock_tpu_torch.tools.shard_ranks",
         "--spec", path, "--out", out, "--rank", str(r), "--world",
         str(world), "--port", str(port), "--backend", backend, "--device",
         device, "--init-timeout", str(init_timeout)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=penv)
        for r in range(world)]
    end = time.monotonic() + deadline
    try:
        # Poll every rank: the first that fails ends the launch, so a
        # rank left waiting in a collective is killed, not waited for.
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise RuntimeError(f"rank {r} of {world} exited with "
                                       f"{p.returncode}:\n{_tail(out, r)}")
            if time.monotonic() > end:
                raise TimeoutError(f"ranks still running after {deadline} "
                                   f"s:\n{_tail(out, 0)}")
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {world} exited with "
                                   f"{p.returncode}:\n{_tail(out, r)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    records = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            records.append(json.load(f))
    with np.load(os.path.join(out, "arrays.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    return records, arrays


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spec", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--backend", required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--init-timeout", type=float, default=60.0)
    args = p.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    run_rank(spec, args.out, rank=args.rank, world=args.world,
             port=args.port, backend=args.backend, device=args.device,
             init_timeout=args.init_timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
