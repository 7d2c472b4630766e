"""The JAX package's decode pool for the port's tests, built once.

Every pytest-xdist worker imports every test file, so several evaluate a
skip gate on the JAX package's pool at once; where its library is not
built yet, each runs the package's ``make`` in the source tree, and one
may load the library while another is still writing it ("file too
short"), mark the pool unavailable for the rest of its life and skip the
comparisons. ``jax_pool_available`` takes an exclusive lock (a file under
the gitignored ``build/``) while it builds or loads, and retries a failed
load, clearing the package loader's failure flag, until the builds that
hold no lock are done too.
"""

import fcntl
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def jax_pool_available(attempts: int = 10, wait_s: float = 2.0) -> bool:
    from emr2a_tpu.data import native_loader as jax_loader

    lock = REPO / "build" / "jax_decode_pool.lock"
    lock.parent.mkdir(exist_ok=True)
    with lock.open("w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        for _ in range(attempts):
            if jax_loader.native_available():
                return True
            jax_loader._build_failed = False
            jax_loader._lib = None
            time.sleep(wait_s)
    return False
