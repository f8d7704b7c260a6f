"""Run-record JSON statistics (reference ``gunrock/util/info.cuh``).

Counterpart of :mod:`gunrock_tpu.utils.info`: primitive name, graph
shape, timing splits (``info.cuh:1309``),
``m_teps = edges_visited / (elapsed_ms * 1000)`` (``info.cuh:1431``),
per-iteration frontier sizes (``info.cuh:684-709``), and the device the
run went to, taken from torch. A record starts no process but the one
cached ``git rev-parse`` of a process's first.
"""

from __future__ import annotations

import datetime
import json
import os
import platform
import subprocess
import sys
from typing import Optional

import torch

__all__ = ["make_info", "write_info", "device_info"]


_GIT_SHA: Optional[str] = None


def _git_sha() -> str:
    """Repo git SHA for run records (reference ``util/gitsha1.h``)."""
    global _GIT_SHA
    if _GIT_SHA is None:
        try:
            _GIT_SHA = subprocess.run(
                ["git", "-C", os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))),
                 "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=5,
            ).stdout.strip() or "unknown"
        except (OSError, subprocess.SubprocessError):
            _GIT_SHA = "unknown"
    return _GIT_SHA


def device_info(device: torch.device) -> dict:
    """Name, platform and count of the device a run went to."""
    if device.type != "cuda":
        return {"name": platform.processor() or platform.machine(),
                "platform": device.type, "num_devices": 1}
    return {"name": torch.cuda.get_device_name(device),
            "platform": "gpu",
            "num_devices": torch.cuda.device_count()}


def make_info(*, primitive: str, graph, stats=None, timer=None,
              edges_visited: Optional[int] = None,
              extra: Optional[dict] = None) -> dict:
    info: dict = {
        "primitive": primitive,
        "engine": "gunrock_tpu_torch",
        "command_line": " ".join(sys.argv),
        "git_commit_sha1": _git_sha(),
        "time": datetime.datetime.now().isoformat(),
        "sysinfo": {"machine": platform.machine(),
                    "system": platform.system(),
                    "python": platform.python_version(),
                    "torch": torch.__version__},
        "gpuinfo": device_info(graph.device),
        "num_vertices": int(graph.num_nodes),
        "num_edges": int(graph.num_edges),
    }
    if timer is not None:
        for k, v in timer.splits.items():
            info[k] = v * 1000.0  # seconds -> ms
    if stats is not None:
        info["num_iterations"] = stats.iteration
        info["nodes_queued"] = int(stats.nodes_queued)
        info["edges_queued"] = int(stats.edges_queued)
        info["frontier_overflow"] = stats.overflow
        info["per_iteration_frontier"] = list(stats.frontier_trace)
        if stats.route:
            info["route"] = stats.route
    if edges_visited is not None:
        info["edges_visited"] = edges_visited
        elapsed_ms = info.get("process_ms", 0.0)
        if elapsed_ms > 0:
            # m_teps = edges_visited / (elapsed_ms * 1000), info.cuh:1431
            info["m_teps"] = edges_visited / (elapsed_ms * 1000.0)
    if extra:
        info.update(extra)
    # avg_duty and the per-phase split (reference info.cuh:1380-1385,
    # util/kernel_runtime_stats.cuh), from instrumented runs' records.
    per_iter = info.get("per_iteration")
    process_ms = info.get("process_ms", 0.0)
    if per_iter and process_ms > 0:
        kernel_ms = sum(r["ms"] for r in per_iter)
        info["avg_duty"] = min(kernel_ms / process_ms, 1.0)
    # Records without a phase (PageRank's) join no split.
    if per_iter and any("phase" in r for r in per_iter):
        phase_ms: dict = {}
        phase_iters: dict = {}
        for r in per_iter:
            if "phase" not in r:
                continue
            phase_ms[r["phase"]] = phase_ms.get(r["phase"], 0.0) + r["ms"]
            phase_iters[r["phase"]] = phase_iters.get(r["phase"], 0) + 1
        info["phase_ms"] = {k: round(v, 3) for k, v in phase_ms.items()}
        info["phase_iterations"] = phase_iters
    return info


def write_info(info: dict, jsonfile: Optional[str] = None,
               jsondir: Optional[str] = None) -> Optional[str]:
    """Write the run record (reference ``--jsonfile`` / ``--jsondir``)."""
    path = jsonfile
    if path is None and jsondir is not None:
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        path = os.path.join(jsondir,
                            f"{info.get('primitive', 'run')}_{stamp}.json")
    if path is None:
        return None
    with open(path, "w") as f:
        json.dump(info, f, indent=2)
    return path
