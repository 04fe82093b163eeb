"""The program's own spans in the traced pass, and the card's idle time by span.

The program keeps named spans of its dataplane in memory while
``repro_torch.obs.timing.recording()`` is open (a pass, a fold step, its
routing, a sync round, the read; their table is in the docstring of
``repro_torch/obs/timing.py``), each a host interval on ``time.time_ns()``,
the clock of the profiler's events.  :func:`recorder` records them over
the first traced pass, which runs under ``torch.profiler`` with CUDA
activity alone and so runs the host 1.5-2.1x slower than an untraced pass:
the spans' host times are those of a traced pass.  A program without the
spans records none, and every reader of them finds nothing.
"""
from __future__ import annotations

import contextlib

import numpy as np

from holonbench.devtrace import union_length

STEP = "holon.fold.step"


@contextlib.contextmanager
def recorder():
    """The program's spans over the traced pass: a list, empty where the
    program has none."""
    from repro_torch.obs import timing

    recording = getattr(timing, "recording", None)
    if recording is None:
        yield []
        return
    with recording() as spans:
        yield spans


def recorded(r, metric: str) -> list:
    """The spans a metric's recorder kept (``[]`` where none)."""
    return r.records.get(metric) or []


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def mean_ms(spans: list, name: str):
    """The mean host milliseconds of the spans named ``name``, or ``None``."""
    mine = named(spans, name)
    if not mine:
        return None
    return sum(s.end_ns - s.start_ns for s in mine) / len(mine) / 1e6


def innermost(spans: list) -> tuple[np.ndarray, np.ndarray]:
    """The innermost open span as a step function of time: ``(times,
    owner)``, span ``owner[j]`` (``-1``: none) from ``times[j]`` on.  The
    spans are one thread's, in the order they began, each inside its
    ``parent``: walking them in that order gives every start and end in
    the order they happened, even where two share a time."""
    times, owner, stack = [], [], []

    def close_to(parent) -> None:
        while stack and stack[-1] != parent:
            j = stack.pop()
            times.append(spans[j].end_ns)
            owner.append(stack[-1] if stack else -1)

    for i, s in enumerate(spans):
        close_to(s.parent)
        times.append(s.start_ns)
        owner.append(i)
        stack.append(i)
    close_to(None)
    return np.array(times, dtype=np.int64), np.array(owner, dtype=np.int64)


def idle_gaps(trace) -> tuple[np.ndarray, np.ndarray]:
    """The card's idle gaps in the traced window, the complement of the union
    of its device events inside ``[t0_ns, t1_ns]``: ``(starts, ends)``."""
    _, us, ue = union_length(trace.starts, trace.ends)
    gs = np.maximum(np.concatenate([[trace.t0_ns], ue]), trace.t0_ns)
    ge = np.minimum(np.concatenate([us, [trace.t1_ns]]), trace.t1_ns)
    keep = ge > gs
    return gs[keep], ge[keep]


def owners(spans: list, times_ns: np.ndarray) -> np.ndarray:
    """The index of the innermost span open at each time (``-1``: none)."""
    if not spans:
        return np.full(len(times_ns), -1, dtype=np.int64)
    times, owner = innermost(spans)
    j = np.searchsorted(times, times_ns, side="right") - 1
    return np.where(j >= 0, owner[np.maximum(j, 0)], -1)


def idle_by_span(trace, spans: list) -> dict:
    """:func:`idle_gaps`, each gap put down to the innermost span open at its
    midpoint: ``{span index or -1: seconds}``."""
    gs, ge = idle_gaps(trace)
    out: dict = {}
    for k, sec in zip(owners(spans, (gs + ge) // 2).tolist(), ((ge - gs) / 1e9).tolist()):
        out[k] = out.get(k, 0.0) + sec
    return out


def within(spans: list, name: str) -> np.ndarray:
    """For each span, whether it is named ``name`` or lies inside one."""
    inside = np.zeros(len(spans), dtype=bool)
    for i, s in enumerate(spans):  # a parent comes before its children
        inside[i] = s.name == name or (s.parent is not None and inside[s.parent])
    return inside


def idle_by_name(trace, spans: list) -> dict:
    """:func:`idle_by_span` summed by span name (``""``: in no span)."""
    out: dict = {}
    for i, sec in idle_by_span(trace, spans).items():
        name = spans[i].name if i >= 0 else ""
        out[name] = out.get(name, 0.0) + sec
    return out
