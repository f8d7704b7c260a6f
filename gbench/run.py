"""Run one cell of the benchmark of gunrock_tpu_torch.

    python3 gbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``gbench/``
and the program. One process, one run: set-up (the program's import,
host build, upload and one warm-up query), a closed loop of queries for
``--seconds``, with ``--trace 1`` a profiled stretch of whole queries
after it, then the comparison of a sample of the answers with the plain
reference. Standard output ends with one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``, each number compared with its
limit (also the last lines of standard error). The line before it
holds the benchmark's own generator and reference times, apart from
``setup_s``.

It exits non-zero and prints no result where CUDA is absent, where the
card has fewer devices than the cell asks for, where the program cannot
be imported, or where jax or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every compile cache at a fixed place inside the checkout.
CACHE = os.path.join(ROOT, "build", "gbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(CACHE, "torch_kernels")
# Python's bytecode too: where the environment forbids writing it (and
# the installed torch ships none), every run compiles torch's and the
# program's sources again, seconds of set-up that swing with the host.
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    t = time.perf_counter()
    import torch
    from gbench import harness
    t_import = time.perf_counter() - t

    bench = harness.Bench(ROOT)
    chips = int(bench.workload(args.workload)["chips"])
    t = time.perf_counter()
    if not torch.cuda.is_available():
        print("gbench: CUDA is not available", file=sys.stderr)
        return 2
    print(f"[gbench] start: torch imported in {t_import:.3f} s, the CUDA "
          f"driver found in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    if torch.cuda.device_count() < chips:
        print(f"gbench: {torch.cuda.device_count()} CUDA devices, the cell "
              f"needs {chips}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, aside = harness.run_cell(bench, args.workload, args.seed,
                                     args.seconds, bool(args.trace), device,
                                     T_PROCESS)
    print(f"[gbench] {harness.power_limit()}; peaks: HBM 3.35 TB/s, "
          "float32 67 TFLOP/s (published, at 700 W)", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"gbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"aside": aside}), flush=True)
    for k, c in result["checks"].items():
        lim = f"limit {c['limit']}" if "limit" in c else f"min {c['min']}"
        print(f"check {k} {c['value']} {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
