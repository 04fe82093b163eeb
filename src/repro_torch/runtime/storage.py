"""Remote checkpoint storage (the paper's ``storage.put/get``).

Durable key→blob store (port of ``repro.runtime.storage``).  Values hold
the port's state tensors, on the card or the host: no code path writes a
state tensor in place, so a stored snapshot never changes.  Merge-on-put
keeps the largest ``nxt_idx`` per Algorithm 2's lattice rule, so concurrent
checkpointers of the same partition (allowed by the paper) can never
regress a checkpoint (join-semilattice laws property-tested in
tests/test_storage.py).

All access rides the network fabric's retried request-response tier
(docs/protocol.md §4): the service itself is synchronous and durable;
latency, loss, and retries live on the node↔storage links, and the lattice
rule is exactly what makes re-issued puts harmless.

With telemetry attached (docs/observability.md §2) the store records one
``ckpt.apply`` per put — carrying the *resulting* stored frontier, which is
what the auditor's monotone-frontier invariant checks: put *requests* may
arrive out of order, the applied frontier may never regress — and one
``ckpt.get`` per fetch (hit/miss + the recovered frontier).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class PartitionCheckpoint:
    nxt_idx: int  # next input-log index to read
    nxt_odx: int  # next output index
    emitted_upto: int  # first window id not yet emitted
    shared: Any  # tuple[WState, ...] replica snapshot
    local: Any  # WLocal state (or None)
    # delta-sync coverage marker: per shared spec the (folded, progress) the
    # snapshot covers.  Recovery restarts delta replay from exactly here —
    # a peer whose delta baseline exceeds it gets nacked into a full resync.
    # Host-side numpy (derivable from ``shared``, but kept materialized so
    # storage can compare coverage without touching device arrays).
    baseline: Any = None
    # membership epoch the checkpointing node had gossiped when it took the
    # snapshot (docs/protocol.md §3.3): recovery can tell a pre- from a
    # post-reconfiguration checkpoint, and put() prefers the newer view on
    # otherwise-equal snapshots.
    epoch: int = 0


def _progress_of(ckpt: PartitionCheckpoint) -> tuple:
    """The snapshot's per-partition watermark vector (first shared spec's
    progress — the one ``global_watermark`` reads); () when stateless."""
    if ckpt.baseline is None or not len(ckpt.baseline):
        return ()
    return tuple(int(x) for x in ckpt.baseline[0][1])


def _coverage(ckpt: PartitionCheckpoint) -> float:
    """Total gossip coverage of a checkpoint (sum of folded frontiers)."""
    if ckpt.baseline is None:
        return 0.0
    return float(sum(folded.sum() for folded, _ in ckpt.baseline))


class CheckpointStorage:
    def __init__(self, telemetry=None):
        self._data: dict[int, PartitionCheckpoint] = {}
        self.puts = 0
        self.gets = 0
        self.obs = telemetry  # Telemetry or None (docs/observability.md §2)

    def put(self, pid: int, ckpt: PartitionCheckpoint) -> None:
        self.puts += 1
        cur = self._data.get(pid)
        # Algorithm 2: lattice merge keeps the state with the largest nxtIdx;
        # ties broken by delta-sync coverage (richer gossip wins, so recovery
        # replays the fewest deltas), then by membership epoch (newer view).
        applied = cur is None or (
            (ckpt.nxt_idx, _coverage(ckpt), ckpt.epoch)
            >= (cur.nxt_idx, _coverage(cur), cur.epoch)
        )
        if applied:
            self._data[pid] = ckpt
        if self.obs is not None and self.obs.on:
            stored = self._data[pid]
            self.obs.event(
                "ckpt.apply", node="storage", partition=pid,
                status="applied" if applied else "kept",
                nxt_idx=stored.nxt_idx, epoch=stored.epoch,
                # stored snapshot's progress vector (first shared spec):
                # critical-path analysis restores adopted lanes from exactly
                # what a later ckpt.get hands out (obs/critpath.py)
                wm=_progress_of(stored),
            )
            self.obs.registry.counter("ckpt_puts", partition=pid).inc()

    def get(self, pid: int) -> PartitionCheckpoint | None:
        self.gets += 1
        ck = self._data.get(pid)
        if self.obs is not None and self.obs.on:
            self.obs.event(
                "ckpt.get", node="storage", partition=pid,
                status="hit" if ck is not None else "miss",
                nxt_idx=ck.nxt_idx if ck is not None else -1,
            )
            self.obs.registry.counter("ckpt_gets", partition=pid).inc()
        return ck

    def has(self, pid: int) -> bool:
        return pid in self._data
