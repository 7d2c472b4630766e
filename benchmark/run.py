"""One run of one cell:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (``core/harness.py``).
"""

import time

T0 = time.perf_counter()   # set-up is counted from here

if __name__ == "__main__":
    import sys

    from benchmark.core.harness import main

    sys.exit(main(sys.argv[1:], T0))
