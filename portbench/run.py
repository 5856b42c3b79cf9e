"""Benchmark entry point of the PyTorch/CUDA port (``src/repro_torch``).

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA device(s) the
cell asks for. One process, one card: set-up, warm-up, a window of
``--seconds``, the check against the plain reference, and the result as
the last line of standard output (one JSON object). Exits non-zero with no
result when the card is missing or a JAX module was loaded.
"""
import time

T_START = time.perf_counter()

import sys                      # noqa: E402
from pathlib import Path        # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
