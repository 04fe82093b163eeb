"""Wall-clock and sim-time stopwatches (port of ``repro.obs.timing``).

The two clocks are separate types, so a number always says which clock it
came from: the discrete-event runtimes live in simulated milliseconds
(:class:`SimTimer`), the dataplane and benchmark drivers on the host's wall
clock (:class:`WallTimer`).  The card runs asynchronously to the host, so
:class:`WallTimer` synchronises the device before it reads the clock at
either end: the time it reports covers the work enqueued inside it, not
just its enqueueing.

The dataplane's spans (:func:`span`, :func:`recording`) are the wall
clock's other reader, and the only one inside the dataplane's loops.  No
sim path opens one, and the runtimes' trace ring never sees them:

=======================  ====================================================  =======
span                     where                                                 one per
=======================  ====================================================  =======
``holon.pass``           ``build_pipeline``'s ``run``; ``KeyedPipeline``'s     pass
                         call
``holon.fold.step``      the dense loop around ``log.batch`` and               batch
                         ``query.fold``; the keyed step body
``holon.fold.route``     the keyed routing: ``shard_of``/``local_of``, the     step
                         routing stack, ``mesh.all_to_all``
``holon.sync.round``     dense: every spec's ``delta_axis_join``/              round
                         ``axis_join``; keyed: the gated ``mesh.pmax``
``holon.read``           the window reads of both pipelines                    pass
``holon.gather_outputs`` ``gather_outputs``                                    pass
=======================  ====================================================  =======

A mesh's collectives have no span of their own: they run inside the route,
the round, the read or the gather, and ``DistMesh.stats`` times them.

Off by default: outside a :func:`recording` :func:`span` returns one
shared object that does nothing (no clock read, no profiler range, no
record).  On or off, no span reads the device, copies to the host or
synchronises, so a pass's outputs are bitwise the same either way.
``with recording() as spans:`` turns them on for the block and yields the
list of :class:`Span` records.  Each span enters a profiler range of its
name and reads ``time.time_ns()`` just inside it, the clock of the
profiler's events, so the spans can be laid beside a device trace.  To see
them on a timeline, profile inside a recording and export::

    with recording(), torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        pipe(log)
    prof.export_chrome_trace("pass.json")  # chrome://tracing or Perfetto

The ``holon.*`` ranges appear on the host's row above the kernels they
launched.
"""
from __future__ import annotations

import contextlib
import dataclasses
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


_RANGE = torch._C._profiler._RecordFunctionFast  # a light profiler range: a host op of the trace


@dataclasses.dataclass
class Span:
    """One recorded span: ``parent`` is the index of the span it opened in
    (``None`` at the top), ``start_ns``/``end_ns`` its interval on
    ``time.time_ns()``."""

    name: str
    parent: int | None
    start_ns: int
    end_ns: int


class _Recording:
    """The spans' state: ``spans`` is ``None`` while no recording is open."""

    def __init__(self):
        self.depth = 0
        self.spans: list[Span] | None = None
        self.open: list[int] = []


_REC = _Recording()


class _NoSpan:
    """What :func:`span` returns while no recording is open."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "range", "record")

    def __init__(self, name: str):
        self.name, self.range = name, _RANGE(name)

    def __enter__(self) -> Span:
        rec = _REC
        self.range.__enter__()
        start = time.time_ns()  # first thing inside the range
        self.record = Span(self.name, rec.open[-1] if rec.open else None, start, start)
        rec.open.append(len(rec.spans))
        rec.spans.append(self.record)
        return self.record

    def __exit__(self, *exc) -> None:
        self.record.end_ns = time.time_ns()  # last thing inside the range
        _REC.open.pop()
        self.range.__exit__(*exc)


def span(name: str):
    """A context manager around one part of the dataplane, named ``name``
    (``holon.*``).  While no :func:`recording` is open it is one shared
    object that does nothing.  While one is open it enters a profiler
    range of ``name`` and records a :class:`Span`."""
    if _REC.spans is None:
        return _NO_SPAN
    return _OpenSpan(name)


@contextlib.contextmanager
def recording():
    """Turn the spans on for the block and yield the list they are recorded
    in.  Re-entrant: a recording opened inside another yields the same list,
    and the spans go off when the outermost one closes."""
    rec = _REC
    if rec.depth == 0:
        rec.spans, rec.open = [], []
    rec.depth += 1
    try:
        yield rec.spans
    finally:
        rec.depth -= 1
        if rec.depth == 0:
            rec.spans = None
