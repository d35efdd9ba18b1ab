"""Run one cell of the benchmark once (see `gpbench/harness.py`):

    python3 -m gpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import sys

from gpbench.harness import main

if __name__ == "__main__":
    sys.exit(main())
