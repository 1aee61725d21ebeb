"""One run of one benchmark cell of the PyTorch port (``medmoe_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
The last line of standard output is the result (JSON); the compared
numbers and their limits are the last lines of standard error.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the run inside the checkout, at fixed paths
_CACHE = os.path.join(ROOT, "benchmark", "out", "cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(_CACHE, sub)
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
