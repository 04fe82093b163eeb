"""Device-side Nexmark event generator (port of ``repro.streaming.generator``).

Produces the whole logged input stream up front, on the device, from an
explicit ``torch.Generator`` seeded with ``cfg.seed``: per partition, a
batch axis of ``events_per_batch`` events.  The load shape is the JAX
package's: timestamps evenly spaced over the batch span plus jitter, then
sorted, so a partition produces ``rate_per_partition`` events per second of
event time; the Nexmark mix of 1 person : 3 auctions : 46 bids per 50
events; lognormal(4, 1) prices; uniform auction ids; ``category = auction %
5``; and the ``skew`` validity pattern.  It does not reproduce the JAX
package's threefry bits: the parity tests feed the JAX log in as numpy.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.streaming.events import KIND_AUCTION, KIND_BID, KIND_PERSON, EventBatch

NUM_CATEGORIES = 5  # Nexmark default category count
CHUNK_BATCHES = 64  # batches drawn per generator call (bounds temporaries)


@dataclasses.dataclass(frozen=True)
class NexmarkConfig:
    num_partitions: int = 8
    num_batches: int = 64
    events_per_batch: int = 256
    rate_per_partition: float = 10_000.0  # events / second (event time)
    seed: int = 0
    base_ts: int = 0
    # zipf exponent of per-partition load: partition p keeps a (p+1)^-skew
    # fraction of its events valid (0 = uniform, every event valid)
    skew: float = 0.0
    num_auctions: int = 1000  # auction ids are drawn from [0, num_auctions)

    @property
    def batch_span_ms(self) -> float:
        return 1000.0 * self.events_per_batch / self.rate_per_partition


def _gen_chunk(cfg: NexmarkConfig, b0: int, nb: int, g: torch.Generator, device) -> EventBatch:
    S, B = cfg.num_partitions, cfg.events_per_batch
    f32 = dict(dtype=torch.float32, device=device)
    span = cfg.batch_span_ms
    base = cfg.base_ts + torch.arange(b0, b0 + nb, **f32) * span  # [nb]
    offs = torch.arange(B, **f32) * (span / B)
    jitter = torch.rand((S, nb, B), generator=g, **f32) * (span / B)
    ts = torch.sort(base[None, :, None] + offs + jitter, dim=-1).values.to(torch.int32)

    lane = torch.arange(B, device=device) % 50
    kind = torch.where(lane == 0, KIND_PERSON, torch.where(lane < 4, KIND_AUCTION, KIND_BID))
    kind = kind.to(torch.int32).expand(S, nb, B).contiguous()
    auction = torch.randint(0, cfg.num_auctions, (S, nb, B), generator=g,
                            dtype=torch.int64, device=device)
    category = (auction % NUM_CATEGORIES).to(torch.int32)
    price = torch.exp(torch.randn((S, nb, B), generator=g, **f32) + 4.0)
    bidder = torch.randint(0, 10_000, (S, nb, B), generator=g, dtype=torch.int64, device=device)

    # skewed load, Bresenham-spread over the batch; the last event is always
    # kept so every partition's watermark reaches the span's end
    frac = (torch.arange(S, **f32) + 1.0) ** -cfg.skew  # [S]
    lane_f = torch.arange(B, **f32)
    valid = torch.floor((lane_f + 1.0) * frac[:, None]) > torch.floor(lane_f * frac[:, None])
    valid = (valid | (torch.arange(B, device=device) == B - 1))[:, None, :].expand(S, nb, B)
    return EventBatch(ts, kind, auction, price, category, bidder, valid.contiguous())


def generate_log(cfg: NexmarkConfig, device="cuda") -> EventBatch:
    """Full input log: EventBatch of ``[num_partitions, num_batches, B]``
    tensors on ``device``, the same for the same ``cfg`` and device."""
    g = torch.Generator(device=device)
    g.manual_seed(cfg.seed)
    shape = (cfg.num_partitions, cfg.num_batches, cfg.events_per_batch)
    log = None
    for b0 in range(0, cfg.num_batches, CHUNK_BATCHES):
        nb = min(CHUNK_BATCHES, cfg.num_batches - b0)
        chunk = _gen_chunk(cfg, b0, nb, g, device)
        if log is None:
            log = chunk.map(lambda x: torch.empty(shape, dtype=x.dtype, device=device))
        for f in dataclasses.fields(EventBatch):
            getattr(log, f.name)[:, b0:b0 + nb] = getattr(chunk, f.name)
    return log


def batch_watermark(batch: EventBatch) -> torch.Tensor:
    """Largest valid event time of each partition's batch ``[S, B]`` -> ``[S]``
    (partition-ordered streams: the partition's local watermark after it)."""
    return torch.where(batch.valid, batch.ts, -(2**31)).amax(-1)
