"""The benchmark of ``manual_whisper_tpu_torch`` on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout: the cells are in ``BENCHMARK.json``, and
the port is imported from the checkout.  See ``harness/main.py``.
"""

import os
import sys
import time

_T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.getcwd()]

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.main(t_start=_T0))
