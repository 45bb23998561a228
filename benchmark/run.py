"""Run one benchmark cell once on the card and print its result line.

    python3 benchmark/run.py --workload rfn_mnist.train_b720 --seed 7 --seconds 50 --trace 0

from the root of a checkout. The last line of standard output is the JSON
result; the numbers the check compares, each with its limit, are the last
lines of standard error. Exits with an error, printing no result, where
there is no CUDA card.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel and compiler caches inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "benchmark", ".cache", sub)
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
