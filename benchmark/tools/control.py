"""One run of a cell's control: the program with the configuration's
``control`` keys in place of its own (a lower precision of the program's
own, such as its int8 path), the same harness, traffic and judgement, so
the compared numbers can be read against the sound runs'.

    python3 -m benchmark.tools.control --workload <name> --seed <n> --seconds <s>

Prints the result line as ``benchmark.run`` does; ``correct`` is expected
to come out false. The benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    t0 = time.perf_counter()
    from benchmark.core import harness, registry

    args = harness.parse(argv)
    root = Path.cwd()
    harness._cache_dirs(root)
    bench = registry.load_benchmark(root)
    cfg = registry.config(bench, registry.workload(bench, args.workload)["config"], root)
    ctx = harness.build_context(args, root, "cuda:0", overrides=cfg["control"])
    out = harness.run_cell(ctx, args.seconds, t0)
    out["control"] = cfg["control"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
