"""The benchmark of nbodysim_tpu_torch: one run of one cell.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in
BENCHMARK.json at the root of the checkout; see benchmark/harness/cli.py.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Every cache of the program and its compilers at a fixed path inside the
# checkout, so that a second run there finds what the first one built.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(HERE / ".cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(ROOT)]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
