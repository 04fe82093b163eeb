"""Window assigners (port of ``repro.core.window``).

``assign(ts)`` gives the window ids an event belongs to, ``end_ts(wid)``
when a window closes, and ``first_dirty_wid(frontier_ts)`` the smallest
window any event with ``ts >= frontier_ts`` can land in.  Methods take
Python ints or int32 tensors; tensor division is floor division, exact for
the negative intermediate of ``first_dirty_wid`` near the stream start, as
Python's ``//`` is for ints.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.lattice import as_dtype


def _floordiv(x, d: int):
    if isinstance(x, torch.Tensor):
        return torch.div(x, d, rounding_mode="floor")
    return x // d


@dataclasses.dataclass(frozen=True)
class Hopping:
    """Windows of length ``window_len`` starting every ``hop``.

    Window ``w`` covers ``[w*hop, w*hop + window_len)``; each event belongs
    to ``window_len // hop`` consecutive windows (fewer near t=0).  ``hop``
    must divide ``window_len`` so that the number K of lanes an event
    expands into is static.
    """

    window_len: int
    hop: int

    def __post_init__(self):
        if self.hop <= 0 or self.window_len <= 0:
            raise ValueError(f"window_len and hop must be positive: {self}")
        if self.hop > self.window_len:
            raise ValueError(f"hop must not exceed window_len: {self}")
        if self.window_len % self.hop:
            raise ValueError(f"hop must divide window_len: {self}")

    @property
    def windows_per_event(self) -> int:
        """K: the number of windows an (interior) event belongs to."""
        return self.window_len // self.hop

    def assign(self, ts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Window ids of each event, newest first: ``(wids, valid)`` with a
        trailing ``[K]`` axis; ``valid`` masks ids that start before t=0."""
        ts = ts.to(torch.int32)
        hi = _floordiv(ts, self.hop)
        offs = torch.arange(self.windows_per_event, dtype=torch.int32, device=ts.device)
        wids = hi.unsqueeze(-1) - offs
        return wids, wids >= 0

    def window_of(self, ts):
        """The newest window containing ``ts`` (the only one when K=1)."""
        if isinstance(ts, torch.Tensor):
            ts = as_dtype(ts, torch.int32)
        return _floordiv(ts, self.hop)

    def contains(self, wid, ts):
        start = wid * self.hop
        return (ts >= start) & (ts < start + self.window_len)

    def start_ts(self, wid):
        return wid * self.hop

    def end_ts(self, wid):
        return wid * self.hop + self.window_len

    def complete(self, wid, gwm):
        """Final, and the same on every replica, once the global watermark
        passes the window's end."""
        return gwm >= self.end_ts(wid)

    def first_dirty_wid(self, frontier_ts):
        """``floor((frontier_ts - window_len) / hop) + 1``, clamped at 0."""
        w = _floordiv(frontier_ts - self.window_len, self.hop) + 1
        if isinstance(w, torch.Tensor):
            return w.clamp(min=0)
        return max(int(w), 0)


@dataclasses.dataclass(frozen=True)
class Tumbling(Hopping):
    """Non-overlapping windows: ``Hopping(window_len, window_len)``, K=1."""

    hop: int = 0  # pinned to window_len in __post_init__

    def __post_init__(self):
        if self.hop == 0:
            object.__setattr__(self, "hop", self.window_len)
        if self.hop != self.window_len:
            raise ValueError("Tumbling windows have hop == window_len; "
                             f"got {self} — use Hopping for overlap")
        super().__post_init__()


WindowAssigner = Hopping


def as_assigner(window_len: int, hop: int | None = None) -> WindowAssigner:
    """``hop in (None, 0, window_len)`` means tumbling, else hopping."""
    if hop is None or hop == 0 or hop == window_len:
        return Tumbling(window_len)
    return Hopping(window_len, hop)


def expand_events(
    assigner: WindowAssigner, ts: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand ``[..., B]`` events into the ``[..., B*K]`` multi-emit lanes.

    Lane ``b*K + k`` carries event ``b``'s k-th (newest-first) window id;
    lanes whose window starts before t=0 are masked out.  Payloads follow
    with ``repeat_interleave(K)`` along the lane axis.
    """
    wids, in_win = assigner.assign(ts)
    return wids.flatten(-2), (mask.unsqueeze(-1) & in_win).flatten(-2)
