"""Typed trace records + bounded ring buffer (docs/observability.md §2).

One :class:`TraceEvent` per protocol occurrence — fabric message, batch
fold, window emission, sync merge, checkpoint put/get, crash/steal/recover,
join/drain — replacing the fabric's old ad-hoc ``(t, src, dst, …)`` tuples.
Records are frozen and slotted: equality is field-wise, so "same seed ⇒
identical trace" is a plain ``==`` over two runs, and creation stays cheap
enough for hot paths.

Every timestamp is **simulated** milliseconds (``Sim.now``); recording makes
no RNG draws and schedules no simulator events, so tracing can never perturb
the run it observes — determinism is what makes the trace auditable
(obs/audit.py, docs/observability.md §4).

The :class:`TraceBuffer` is a bounded ring: long chaos sweeps cannot grow
memory without bound — the oldest records fall off and ``dropped`` counts
them, which the auditor treats as "trace truncated" (it refuses to certify
invariants it cannot see).  With a ``spill_path`` configured
(``SimConfig.obs_spill_path``) evicted records stream to a JSONL spool
instead of vanishing: resident memory stays bounded at ``cap`` records while
``spilled_events()`` + the ring reconstruct the full stream, so long runs
stay auditable (docs/observability.md §3).
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Iterable


@dataclasses.dataclass(frozen=True, slots=True)
class TraceEvent:
    """One protocol occurrence.  ``kind`` names the span taxonomy entry
    (docs/observability.md §2); unused fields keep their defaults so records
    stay compact and field-wise comparable."""

    t_ms: float  # sim-time of the record (span start)
    kind: str  # taxonomy name, e.g. "net.msg", "exec.batch", "emit"
    node: Any = None  # primary actor: node id, "storage", or None
    partition: int = -1
    window: int = -1
    src: Any = None  # message source endpoint (net/sync records)
    dst: Any = None  # message destination endpoint
    cls: str = ""  # fabric message class ("sync", "hb", "ckpt_put", …)
    nbytes: float = 0.0
    status: str = ""  # e.g. "ok"/"lost"/"accepted"/"delta_merge"/"nack"
    t_end_ms: float = -1.0  # span end / scheduled delivery; -1 = instant
    args: tuple = ()  # sorted ((key, value), …) extras — deterministic

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default


def mkargs(**kw) -> tuple:
    """Canonical ``args`` encoding: key-sorted tuple of pairs, so equal
    payloads are equal records and JSON export is byte-stable."""
    return tuple(sorted(kw.items()))


class TraceBuffer:
    """Bounded ring of :class:`TraceEvent`; drops the oldest on overflow.

    With ``spill_path`` set the oldest records are streamed to a JSONL spool
    file on eviction instead of being discarded: resident memory stays
    bounded at ``cap`` while the spool + ring together hold the complete
    stream (``spilled`` counts spooled records; ``dropped`` stays 0).  The
    spool uses the same line format as :func:`to_jsonl`, so
    :func:`from_jsonl` round-trips it and the auditor can replay the whole
    run (docs/observability.md §3)."""

    def __init__(self, cap: int = 1 << 16, spill_path: str = ""):
        self.cap = int(cap)
        self.spill_path = str(spill_path)
        self._buf: deque[TraceEvent] = (
            deque() if self.spill_path else deque(maxlen=self.cap)
        )
        self.total = 0  # records ever appended
        self.spilled = 0  # records evicted to the spool file
        self._spill_fh = None

    def append(self, ev: TraceEvent) -> None:
        self.total += 1
        self._buf.append(ev)
        if self.spill_path and len(self._buf) > self.cap:
            self._spill(self._buf.popleft())

    def _spill(self, ev: TraceEvent) -> None:
        if self._spill_fh is None:
            self._spill_fh = open(self.spill_path, "w")
        self._spill_fh.write(event_json(ev) + "\n")
        self.spilled += 1

    def flush_spill(self) -> None:
        if self._spill_fh is not None:
            self._spill_fh.flush()

    def spilled_events(self) -> list[TraceEvent]:
        """Re-read the spool: the records evicted so far, oldest first."""
        if not self.spilled:
            return []
        self.flush_spill()
        with open(self.spill_path) as fh:
            return from_jsonl(fh.read())

    @property
    def dropped(self) -> int:
        return self.total - len(self._buf) - self.spilled

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)

    def events(self) -> tuple[TraceEvent, ...]:
        return tuple(self._buf)

    def all_events(self) -> list[TraceEvent]:
        """Spool + resident ring: the complete appended stream (equal to
        ``events()`` when nothing spilled)."""
        return self.spilled_events() + list(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self.total = 0
        self.spilled = 0
        if self._spill_fh is not None:
            self._spill_fh.close()
            self._spill_fh = None


# ---------------------------------------------------------------------------
# exporters (docs/observability.md §3)
# ---------------------------------------------------------------------------


def _jsonable(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        # recursive, so nested arg payloads (pids, peers, groups, wm vectors)
        # survive a JSONL round-trip instead of flattening to repr strings
        return [_jsonable(x) for x in v]
    return repr(v)


def event_json(ev: TraceEvent) -> str:
    """The canonical key-sorted JSON line of one record (shared by
    :func:`to_jsonl` and the :class:`TraceBuffer` spill spool)."""
    d = dataclasses.asdict(ev)
    d["args"] = [[k, _jsonable(v)] for k, v in ev.args]
    for k in ("node", "src", "dst"):
        d[k] = _jsonable(d[k])
    return json.dumps(d, sort_keys=True)


def to_jsonl(events: Iterable[TraceEvent], dropped: int = 0) -> str:
    """One key-sorted JSON object per record, preceded by a meta header.
    Deterministic byte-for-byte for a deterministic run (same-seed runs
    export identical strings — tested in tests/test_obs.py)."""
    lines = [json.dumps({"meta": "holon-trace-v1", "dropped": int(dropped)},
                        sort_keys=True)]
    for ev in events:
        lines.append(event_json(ev))
    return "\n".join(lines) + "\n"


def _untuple(v):
    return tuple(_untuple(x) for x in v) if isinstance(v, list) else v


def from_jsonl(text: str) -> list[TraceEvent]:
    """Parse :func:`to_jsonl` / spill-spool output back into records.

    Inverse of :func:`event_json` for every value the runtimes record (JSON
    scalars and nested tuples; tuples come back as tuples).  Meta header
    lines are skipped, so a full export and a bare spool both parse."""
    out: list[TraceEvent] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        if "meta" in d and "kind" not in d:
            continue
        d["args"] = tuple((k, _untuple(v)) for k, v in d["args"])
        out.append(TraceEvent(**d))
    return out


def _pid(endpoint) -> int:
    """Chrome process id for an endpoint: nodes map to their id, the storage
    service to -1, and actor-less records to -2."""
    if endpoint is None:
        return -2
    if isinstance(endpoint, int):
        return endpoint
    return -1  # "storage" (or any non-int service endpoint)


def to_chrome(events: Iterable[TraceEvent]) -> dict:
    """Chrome trace-event JSON (the ``traceEvents`` array format): open a
    chaos run in Perfetto / chrome://tracing as a per-node (process) /
    per-partition (thread) timeline.  Spans (``t_end_ms >= t_ms``) export as
    complete "X" events, point records as instant "i" events; ``ts`` is in
    microseconds per the format."""
    out: list[dict] = []
    seen_pids: set[int] = set()
    for ev in events:
        pid = _pid(ev.node if ev.node is not None else ev.src)
        tid = ev.partition + 1 if ev.partition >= 0 else 0
        seen_pids.add(pid)
        args = {k: _jsonable(v) for k, v in ev.args}
        for k in ("src", "dst"):
            v = getattr(ev, k)
            if v is not None:
                args[k] = _jsonable(v)
        if ev.cls:
            args["cls"] = ev.cls
        if ev.nbytes:
            args["nbytes"] = ev.nbytes
        if ev.status:
            args["status"] = ev.status
        if ev.window >= 0:
            args["window"] = ev.window
        base = {
            "name": ev.kind,
            "cat": ev.kind.split(".", 1)[0],
            "pid": pid,
            "tid": tid,
            "ts": ev.t_ms * 1000.0,
            "args": args,
        }
        if ev.t_end_ms >= ev.t_ms:
            out.append({**base, "ph": "X", "dur": (ev.t_end_ms - ev.t_ms) * 1000.0})
        else:
            out.append({**base, "ph": "i", "s": "p"})
    meta = [
        {
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0, "ts": 0.0,
            "args": {"name": "storage" if pid == -1
                     else ("fabric" if pid == -2 else f"node{pid}")},
        }
        for pid in sorted(seen_pids)
    ]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}
