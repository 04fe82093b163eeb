"""Host wall-clock stopwatch for the dataplane (port of ``repro.obs.timing``).

The card runs asynchronously to the host, so :class:`WallTimer`
synchronises the device before it reads the clock at either end: the time
it reports covers the work enqueued inside it, not just its enqueueing.
"""
from __future__ import annotations

import time

import torch


class WallTimer:
    """Context-manager stopwatch over the host wall clock; ``dt`` in seconds."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "WallTimer":
        self._sync()
        self.t0 = time.perf_counter()
        self.dt = 0.0  # seconds (live until __exit__ freezes it)
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        self.dt = time.perf_counter() - self.t0
