"""Run one cell of the benchmark and print its result line.

    python3 stereobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic, metrics
and limits are found by name (``BENCHMARK.json``, ``stereobench/harness.py``).
The last line of standard output is one JSON object; the numbers the check
compared, each with its limit, are the last lines of standard error.  Exit
codes: 2 without the CUDA devices the cell asks for, 3 when a forbidden module
(JAX or the JAX package) was loaded, 4 when an end-to-end metric is not
finite.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed places inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
sys.path.insert(0, ROOT)

from stereobench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
