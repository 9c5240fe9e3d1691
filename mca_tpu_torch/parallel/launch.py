"""Start N ranks of one command on this host and wait for them: the
helper the multi-rank tests and ``chip_smoke.py`` use (users launch
ranks with ``torchrun``, see :mod:`~mca_tpu_torch.parallel.multihost`).

Rank ``r`` runs the command with ``MCA_COORDINATOR`` (a ``file://``
rendezvous in a fresh temporary directory), ``MCA_NUM_PROCESSES=N``,
``MCA_PROCESS_ID=r`` and ``LOCAL_RANK=r``,
which :func:`mca_tpu_torch.parallel.multihost.init_multihost` reads.  A
rank that fails, or a run that outlives ``timeout`` seconds, ends every
rank and the launch raises :class:`LaunchError` with the tail of each
rank's output.  The ranks stay in the launcher's process group, so that
whatever ends the launcher's group ends them too.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

TAIL_BYTES = 4000


class LaunchError(RuntimeError):
    """A rank failed or the ranks outlived their time."""


def _tail(path: str) -> str:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(f.tell() - TAIL_BYTES, 0))
        return f.read().decode(errors="replace")


def _end(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def launch(
    argv: Sequence[str],
    nproc: int,
    timeout: float = 600.0,
    env: Optional[Dict[str, str]] = None,
    log_dir: Optional[str] = None,
) -> List[str]:
    """Run ``argv`` as ranks ``0..nproc-1``; returns each rank's output
    (stdout and stderr) once every rank has exited 0.  ``log_dir`` keeps
    ``rank<r>.log`` there (a temporary directory otherwise)."""
    with tempfile.TemporaryDirectory(prefix="mca_launch_") as tmp:
        logs = log_dir or tmp
        os.makedirs(logs, exist_ok=True)
        coordinator = f"file://{tmp}/rdzv"
        procs, paths = [], []
        try:
            for r in range(nproc):
                path = os.path.join(logs, f"rank{r}.log")
                rank_env = {**os.environ, **(env or {}), "MCA_COORDINATOR": coordinator,
                            "MCA_NUM_PROCESSES": str(nproc), "MCA_PROCESS_ID": str(r),
                            "LOCAL_RANK": str(r)}
                with open(path, "wb") as out:
                    procs.append(subprocess.Popen(list(argv), env=rank_env, stdout=out,
                                                  stderr=subprocess.STDOUT))
                paths.append(path)
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    _end(procs)
                    why = (f"rank {failed[0]} exited {codes[failed[0]]}" if failed
                           else f"ranks still running after {timeout:.0f} s")
                    raise LaunchError(why + "".join(
                        f"\n--- rank {r} ---\n{_tail(p)}" for r, p in enumerate(paths)))
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.05)
        finally:
            _end(procs)
        outputs = []
        for p in paths:
            with open(p, errors="replace") as f:
                outputs.append(f.read())
        return outputs

