"""gbench: the benchmark of gunrock_tpu_torch on NVIDIA GPUs.

``python3 gbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell
uses is found by name: configurations in ``configs/``, graph generators
in ``graphs/``, traffic mixes in ``traffic/``, plain references in
``reference/`` and metric readers in ``metrics/``. This package imports
nothing of the program under test except through the names its traffic
files give, and never jax or the JAX package.
"""
