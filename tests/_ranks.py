"""Rank processes for the tests of the dataplane across processes.

Each rank is a ``python -c`` script of its own, given ``rank world store
out`` as arguments; the ranks meet through a ``FileStore`` at ``store``.
Every process is joined with a timeout and killed when it or a peer fails.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"


def env(**extra) -> dict:
    """A rank's environment: the port and these helpers on the path, one
    thread, and no launcher's or JAX's settings."""
    out = dict(os.environ, PYTHONPATH=os.pathsep.join((str(SRC), str(TESTS))),
               OMP_NUM_THREADS="1", **extra)
    out.pop("XLA_FLAGS", None)  # a JAX script sets its own device count
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        out.pop(k, None)
    return out


def join_all(procs: list, logs: list, timeout: float) -> None:
    """Wait for every process; on a failure, or at the timeout, kill the
    rest and fail with each failed process's output."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"--- process {i} (exit {procs[i].returncode}) ---\n"
                              f"{Path(logs[i]).read_text()[-3000:]}" for i in bad)


def start_ranks(script: str, world: int, tmp: Path, out: Path) -> tuple[list, list]:
    """Start ``world`` processes of ``script``, each logging to a file under
    ``tmp``: ``(procs, logs)`` for :func:`join_all`."""
    procs, logs = [], []
    for r in range(world):
        logs.append(tmp / f"rank{r}.log")
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(r), str(world), str(tmp / "store"), str(out)],
                stdout=f, stderr=subprocess.STDOUT,
                env=env(LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))))
    return procs, logs
