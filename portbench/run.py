"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload flagship.train --seed 7 --seconds 25 --trace 0

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``wordgesture_gan_tpu_torch``). See ``harness.py``.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
