"""Entry point: ``python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``perfbench/harness.py``)."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))
