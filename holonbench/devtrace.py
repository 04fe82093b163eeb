"""What a ``torch.profiler`` trace of the traced window says about the card.

:func:`read_trace` reduces a finished profile (CPU and CUDA activities) to a
:class:`DeviceTrace`: every device event (kernel, copy, fill) with its
interval, and the top-level torch ops the host ran.  The busy time is the
union of the device events' intervals: the arithmetic of ``chip_smoke.py``'s
``profile_row`` (device time over the wall), except that intervals are
joined rather than added, since ``segment_reduce``'s three kernels overlap
by programmatic dependent launch and a plain sum would count that overlap
twice.  It reads the profiler's raw events, as ``profile_row`` does:
building its function events takes far longer.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np


def union_length(starts: np.ndarray, ends: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
    """Total length of the union of intervals, and the union's intervals."""
    if starts.size == 0:
        return 0.0, starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    u_start = s[idx]
    u_end = np.maximum.reduceat(e, idx)
    return float((u_end - u_start).sum()), u_start, u_end


@dataclasses.dataclass
class DeviceTrace:
    """Device events of one card over a traced window of ``window_s``."""

    window_s: float
    names: list  # device event names
    starts: np.ndarray  # ns
    ends: np.ndarray  # ns
    host_ops: list  # (name, start ns, end ns) of the top-level torch ops, by start
    t0_ns: int  # start of the window on the trace's clock
    t1_ns: int

    @property
    def device_events(self) -> int:
        return len(self.names)

    @property
    def busy_s(self) -> float:
        return union_length(self.starts, self.ends)[0] / 1e9

    def kernel_s(self, *parts: str) -> float:
        """Union of the intervals of the device events whose name holds any of
        ``parts``: the device time of one kernel, its launches' overlaps
        counted once."""
        sel = np.array([any(p in n for p in parts) for n in self.names], dtype=bool)
        if not sel.any():
            return 0.0
        return union_length(self.starts[sel], self.ends[sel])[0] / 1e9

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: ``[[name, seconds]]``."""
        by = Counter()
        for n, s, e in zip(self.names, self.starts, self.ends):
            by[n[:120]] += (e - s) / 1e9
        return [[n, float(v)] for n, v in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The card's idle time inside the window, by what the host was doing:
        each gap between device work is put to the top-level torch op running
        on the host at its midpoint, or to ``python`` where none ran;
        ``[[host op, seconds]]``, the largest totals first."""
        _, us, ue = union_length(self.starts, self.ends)
        gs = np.concatenate([[self.t0_ns], ue])
        ge = np.concatenate([us, [self.t1_ns]])
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        if gs.size == 0:
            return []
        mids = (gs + ge) // 2
        o_start = np.array([s for _, s, _ in self.host_ops], dtype=np.int64)
        o_end = np.array([e for _, _, e in self.host_ops], dtype=np.int64)
        by = Counter()
        i = np.searchsorted(o_start, mids, side="right") - 1
        for k, (a, b) in enumerate(zip(gs, ge)):
            j = i[k]
            name = self.host_ops[j][0] if j >= 0 and o_end[j] > mids[k] else "python"
            by[name] += (b - a) / 1e9
        return [[n, float(v)] for n, v in by.most_common(top)]


WINDOW = "holonbench.window"  # the record_function range around a traced pass


def read_trace(prof, window_s: float) -> DeviceTrace:
    """The device events of a finished profile of one traced pass, and the
    top-level ``aten::`` ops the host ran in it where the profile recorded
    the host's activity.  With the host's activity the window is the
    :data:`WINDOW` range's; without, it is the pass's ``window_s`` on the
    host clock, ending at the last device event."""
    from torch.autograd import DeviceType

    names, starts, ends, aten, window = [], [], [], [], None
    for e in prof.profiler.kineto_results.events():
        if e.name() == WINDOW:
            if e.device_type() == DeviceType.CPU:
                window = (e.start_ns(), e.end_ns())
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            names.append(e.name())
            starts.append(e.start_ns())
            ends.append(e.end_ns())
        elif e.name().startswith("aten::"):
            aten.append((e.start_ns(), -e.end_ns(), e.name()))
    st = np.array(starts, dtype=np.int64)
    en = np.array(ends, dtype=np.int64)
    if window is None:
        t1 = int(en.max()) if en.size else 0
        window = (t1 - int(window_s * 1e9), t1)
    t0, t1 = window
    aten.sort()
    host_ops, end = [], -1
    for s, neg_e, n in aten:  # aten ops inside no other aten op
        if s >= end and t0 <= s <= t1:
            host_ops.append((n, s, -neg_e))
        end = max(end, -neg_e)
    inside = (st >= t0) & (en <= t1)
    return DeviceTrace(window_s=(t1 - t0) / 1e9, names=[n for n, k in zip(names, inside) if k],
                       starts=st[inside], ends=en[inside], host_ops=host_ops, t0_ns=t0, t1_ns=t1)
