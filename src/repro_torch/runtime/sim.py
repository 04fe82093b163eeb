"""Minimal deterministic discrete-event simulator."""
from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable


class Sim:
    def __init__(self):
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._counter = itertools.count()  # FIFO tie-break => determinism
        self.now: float = 0.0

    def at(self, t: float, fn: Callable[[], None]) -> None:
        if t < self.now:
            t = self.now
        heapq.heappush(self._heap, (t, next(self._counter), fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.now + dt, fn)

    def run(self, until: float) -> None:
        while self._heap and self._heap[0][0] <= until:
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            fn()
        self.now = max(self.now, until)
