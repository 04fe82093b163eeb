"""Wall-clock and sim-time stopwatches (port of ``repro.obs.timing``).

The two clocks are separate types, so a number always says which clock it
came from: the discrete-event runtimes live in simulated milliseconds
(:class:`SimTimer`), the dataplane and benchmark drivers on the host's wall
clock (:class:`WallTimer`).  The card runs asynchronously to the host, so
:class:`WallTimer` synchronises the device before it reads the clock at
either end: the time it reports covers the work enqueued inside it, not
just its enqueueing.
"""
from __future__ import annotations

import time

import torch


class WallTimer:
    """Context-manager stopwatch over the host wall clock; ``dt`` in seconds."""

    domain = "wall"

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

    @property
    def dt_ms(self) -> float:
        return self.dt * 1e3


class SimTimer:
    """Context-manager stopwatch over a simulator clock (``domain="sim"``);
    ``dt`` in simulated seconds, the same attribute shape as
    :class:`WallTimer`."""

    domain = "sim"

    def __init__(self, sim):
        self.sim = sim

    def __enter__(self) -> "SimTimer":
        self.t0 = self.sim.now
        self.dt = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.dt = (self.sim.now - self.t0) / 1e3  # sim ms -> "seconds"

    @property
    def dt_ms(self) -> float:
        return self.dt * 1e3
