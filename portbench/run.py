"""Run one cell of the tpufusion_torch benchmark; see ``harness.py``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# CUPTI is torn down after a profiler session only if this is set before
# torch loads; the caches live at fixed paths inside the checkout
os.environ["TEARDOWN_CUPTI"] = "1"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
