"""Starting, watching and joining the other ranks of a run across cards.

Rank 0 is the process the command started; it starts ranks ``1 ..
world - 1`` as processes of their own (the same script with ``--rank``),
one card a rank, and meets them at ``tcp://localhost:<port>``.  A rank that
fails would leave the others waiting in a collective, so a watcher thread
ends the whole run as soon as one exits with an error; on the way out every
rank is joined, and one still running after the grace time is killed.
"""
from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import threading

JOIN_S = 120.0  # grace for the other ranks to finish after rank 0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


@contextlib.contextmanager
def others(script: str, argv: list[str], world: int):
    """Run ranks ``1 .. world - 1`` as ``script argv --rank r --init <address>``
    beside the body, rank 0's work, which gets the address.  Their output
    goes to this process's standard error."""
    init = f"tcp://localhost:{free_port()}"
    me = [sys.executable, script, *argv]
    commands = [[*me, "--rank", str(r), "--init", init] for r in range(1, world)]
    os.environ.update(LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(world))
    procs = []
    for r, cmd in enumerate(commands, start=1):
        env = dict(os.environ, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
        procs.append(subprocess.Popen(cmd, stdout=sys.stderr, stderr=sys.stderr, env=env))
    done = threading.Event()

    def watch():
        while not done.wait(0.5):
            bad = [(r, p.returncode) for r, p in enumerate(procs, start=1)
                   if p.poll() not in (None, 0)]
            if bad:
                print(f"rank(s) {bad} failed (rank, exit code); ending the run",
                      file=sys.stderr, flush=True)
                _kill(procs)
                os._exit(1)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        yield init
        done.set()
        watcher.join()
        for p in procs:
            try:
                p.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                pass
        bad = [(r, p.returncode) for r, p in enumerate(procs, start=1) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"rank(s) {bad} failed or outlived rank 0 (rank, exit code)")
    finally:
        done.set()
        _kill(procs)
