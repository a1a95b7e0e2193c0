#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The run makes its inputs and weights from
``--seed``, loads and warms the program (horizonnet_tpu_torch), measures
for ``--seconds`` seconds, checks every result against the plain
reference in benchmark/reference/, and prints one JSON object as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number with its limit (also the last
lines of standard error). Without a CUDA device it exits with 2 and
prints no result. Build and kernel caches stay inside the checkout
(build/).
"""

import time

T_START = time.perf_counter_ns()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, os.path.join(ROOT, "build", sub))

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
