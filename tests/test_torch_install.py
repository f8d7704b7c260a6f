"""The port as an installed package, on the CPU.

A wheel is built offline from a copy of the tree (``pip wheel --no-deps
--no-build-isolation``; building in the repository would write
``build/`` and ``*.egg-info`` into it) and installed with ``pip install
--no-deps --no-index --target`` into a temporary directory. Subprocesses
whose ``sys.path`` reaches the package only through that directory then
check what an installed user meets: the kernel sources and the C shim's
sources beside the package, the build directory under the target, the
submodules after a bare import, the CLI and its console script. A fresh
interpreter also checks what ``import gunrock_tpu_torch`` leaves alone.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import zipfile

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = ("bfs_kernels.cu", "pull_kernels.cu", "sssp_kernels.cu", "tiles.cuh",
        "c_api.cpp", "gunrock_tpu_torch.h")
PIP = (sys.executable, "-m", "pip", "--disable-pip-version-check",
       "--no-cache-dir")
CLI_ARGS = ("bfs", "rmat", "--rmat_scale=8", "--direction-optimized",
            "--device=cpu")

PROBE = r"""
import json, os, sys
import gunrock_tpu_torch as gtt
from gunrock_tpu_torch import capi
from gunrock_tpu_torch.graph import native
from gunrock_tpu_torch.ops import _build
import numpy as np
g = gtt.from_coo(5, np.array([0, 1, 2, 3]), np.array([1, 2, 3, 4]),
                 undirected=True)
print(json.dumps({
    "file": gtt.__file__, "path": sys.path,
    "library_path": _build.library_path(), "build_dir": native.build_dir(),
    "capi_header_dir": capi.CAPI_HEADER_DIR,
    "capi_files": sorted(os.listdir(capi.CAPI_HEADER_DIR)),
    "bfs_sharded": gtt.parallel.bfs_sharded.__module__,
    "submodules": [m for m in ("graph", "ops", "models", "utils", "parallel")
                   if hasattr(gtt, m)],
    "native_lib": native.get_lib() is not None,
    "row_offsets": g.row_offsets.tolist()}))
"""


def _env(site: str) -> dict:
    """The environment of a process that finds the package only in
    ``site``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = site
    return env


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """A wheel built offline from a copy of the tree."""
    work = tmp_path_factory.mktemp("wheel")
    src = work / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(_REPO, name), src / name)
    for pkg in ("gunrock_tpu", "gunrock_tpu_torch"):
        shutil.copytree(os.path.join(_REPO, pkg), src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__", "build"))
    r = subprocess.run([*PIP, "wheel", "--no-deps", "--no-build-isolation",
                        "--no-index", "-w", str(work / "dist"), str(src)],
                       capture_output=True, text=True, timeout=180,
                       cwd=work)
    assert r.returncode == 0, r.stderr[-3000:]
    (path,) = (work / "dist").glob("*.whl")
    return str(path)


@pytest.fixture(scope="module")
def site(wheel, tmp_path_factory):
    """The wheel installed with ``--target``, away from the repository."""
    target = str(tmp_path_factory.mktemp("installed") / "site")
    r = subprocess.run([*PIP, "install", "--no-deps", "--no-index",
                        "--target", target, wheel],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    return target


@pytest.fixture(scope="module")
def probe(site):
    r = subprocess.run([sys.executable, "-c", PROBE], env=_env(site),
                       cwd=os.path.dirname(site), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_wheel_holds_the_kernel_sources_and_both_console_scripts(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        (entry,) = [n for n in names if n.endswith("entry_points.txt")]
        scripts = z.read(entry).decode()
    for name in CSRC:
        assert f"gunrock_tpu_torch/csrc/{name}" in names, name
    assert "gunrock-tpu = gunrock_tpu.cli:main" in scripts
    assert "gunrock-tpu-torch = gunrock_tpu_torch.cli:main" in scripts


def test_installed_copy_is_the_one_imported(site, probe):
    assert probe["file"].startswith(os.path.join(site, "gunrock_tpu_torch"))
    assert _REPO not in probe["path"]


def test_installed_kernel_library_builds_under_the_target(site, probe):
    """``library_path()`` hashes every source and header of ``csrc/``
    (it raised FileNotFoundError on ``tiles.cuh`` before the package data
    listed it) and names a file under the target's build directory."""
    build = os.path.join(site, "build", "gunrock_tpu_torch")
    assert probe["build_dir"] == build
    assert os.path.dirname(probe["library_path"]) == build


def test_installed_capi_header_dir_holds_the_shim_sources(site, probe):
    assert probe["capi_header_dir"] == os.path.join(
        site, "gunrock_tpu_torch", "csrc")
    assert set(CSRC) <= set(probe["capi_files"])


def test_installed_submodules_resolve_after_a_bare_import(probe):
    assert probe["bfs_sharded"] == "gunrock_tpu_torch.parallel.bfs"
    assert probe["submodules"] == ["graph", "ops", "models", "utils",
                                   "parallel"]


def test_installed_copy_has_no_native_builder_and_takes_numpy(probe):
    """No ``native/graph_builder.cpp`` beside an installed copy: the host
    builder is unavailable and ``from_coo`` takes its numpy path."""
    assert probe["native_lib"] is False
    assert probe["row_offsets"] == [0, 1, 3, 5, 7, 8]


@pytest.mark.parametrize("how", ["module", "console_script"])
def test_installed_cli_bfs_is_correct(site, how):
    if how == "module":
        cmd = [sys.executable, "-m", "gunrock_tpu_torch", *CLI_ARGS]
    else:
        cmd = [os.path.join(site, "bin", "gunrock-tpu-torch"), *CLI_ARGS]
    r = subprocess.run(cmd, env=_env(site), cwd=os.path.dirname(site),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "bfs validation: CORRECT" in r.stdout
    assert "INCORRECT" not in r.stdout


IMPORT_CHECK = r"""
import json, sys
import gunrock_tpu_torch as gtt
import torch
build = gtt.graph.native.build_dir()
kernels = sys.modules.get("gunrock_tpu_torch.ops._build")
maps = open("/proc/self/maps").read() if sys.platform == "linux" else ""
print(json.dumps({
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")),
    "gunrock_tpu": sorted(m for m in sys.modules if m == "gunrock_tpu"
                          or m.startswith("gunrock_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
    "distributed": torch.distributed.is_available()
    and torch.distributed.is_initialized(),
    "kernels_loaded": kernels is not None and kernels._lib is not None,
    "native_loaded": gtt.graph.native._lib is not None,
    "build_dir_mapped": build in maps,
    "submodules": [m for m in ("graph", "ops", "models", "utils", "parallel",
                               "io", "api") if hasattr(gtt, m)]}))
"""


def test_bare_import_loads_no_jax_no_cuda_no_library():
    """In a fresh interpreter, ``import gunrock_tpu_torch`` (which now
    imports every subpackage) imports neither jax nor the JAX package,
    initialises neither CUDA nor a process group, and loads no library of
    the port's build directory."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    r = subprocess.run([sys.executable, "-c", IMPORT_CHECK], env=env,
                       cwd=_REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["jax"] == [] and out["gunrock_tpu"] == []
    assert not out["cuda_initialized"] and not out["distributed"]
    assert not out["kernels_loaded"] and not out["native_loaded"]
    assert not out["build_dir_mapped"]
    assert out["submodules"] == ["graph", "ops", "models", "utils",
                                 "parallel", "io", "api"]
