"""Start one process a rank on this host through PyTorch's ``torchrun``.

JAX's multi-process test starts its workers as OS processes on one host
(``tests/test_multiprocess_dcn.py``); the port's tools and tests do the
same through ``launch``, which runs

    python -m torch.distributed.run --standalone --nproc-per-node N <args>

(``torchrun``: a free port of this host, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set for each rank; a
rank that fails stops the others) and returns every rank's output, each
line prefixed ``[defaultR]:``. A failed rank, or ``timeout`` seconds, raise
``WorkerFailed`` with that output; on the timeout ``torchrun`` is asked to
stop its ranks (SIGTERM) before it is killed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Dict, Optional, Sequence


class WorkerFailed(RuntimeError):
    pass


def launch(args: Sequence[str], processes: int, timeout: float,
           env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None) -> str:
    """Run ``processes`` ranks of ``torchrun``'s ``<args>`` (a script and its
    arguments, or ``-m module ...``); returns their output."""
    environ = dict(os.environ if env is None else env)
    # torchrun would set 1; each rank gets its share of the host's cores
    environ.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // processes)))
    with tempfile.TemporaryDirectory(prefix="emr2a_launch_") as logs:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={processes}", "--tee=3", f"--log-dir={logs}", *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=environ,
            cwd=cwd)
        try:
            output, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                output, _ = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                output, _ = proc.communicate()
            raise WorkerFailed(f"the ranks did not end within {timeout:.0f} s\n{output}")
    if proc.returncode != 0:
        raise WorkerFailed(f"torchrun exited with code {proc.returncode}\n{output}")
    return output
