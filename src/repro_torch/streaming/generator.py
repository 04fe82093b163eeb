"""Device-side Nexmark event generator (port of ``repro.streaming.generator``).

Produces the whole logged input stream up front, on the device: per
partition, a batch axis of ``events_per_batch`` events.  It draws the JAX
package's log for the same ``NexmarkConfig``: batch ``b`` of partition
``p`` draws from ``fold_in(fold_in(PRNGKey(seed), p), b)`` split in four,
through the port of JAX's threefry in ``streaming/prng.py``, and every f32
step is the one XLA takes.  The load shape: timestamps evenly spaced over
the batch span plus jitter, then sorted, so a partition produces
``rate_per_partition`` events per second of event time; the Nexmark mix of
1 person : 3 auctions : 46 bids per 50 events; lognormal(4, 1) prices;
uniform auction ids, or zipf-like ones under ``key_skew``;
``category = auction % 5``; and the ``skew`` validity pattern.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.streaming import prng
from repro_torch.streaming.events import KIND_AUCTION, KIND_BID, KIND_PERSON, EventBatch

NUM_CATEGORIES = 5  # Nexmark default category count
CHUNK_BATCHES = 64  # batches drawn per pass (bounds the int64 temporaries)


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
    # zipf exponent of auction ids: id i is drawn with mass ~ (i+1)^-key_skew
    # (0 = uniform)
    key_skew: float = 0.0

    @property
    def batch_span_ms(self) -> float:
        return 1000.0 * self.events_per_batch / self.rate_per_partition


def _gen_chunk(cfg: NexmarkConfig, b0: int, nb: int, parts: range, device) -> EventBatch:
    """Batches ``b0 .. b0 + nb`` of the partitions ``parts``: one threefry
    key per (partition, batch), all drawn at once along the event axis."""
    S, B = len(parts), cfg.events_per_batch
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    p = torch.arange(parts.start, parts.stop, parts.step, **i64)  # [S] partition ids
    key = prng.fold_in(prng.prng_key(cfg.seed, device), p[:, None])
    key = prng.fold_in(key, torch.arange(b0, b0 + nb, **i64)[None, :])  # [S, nb]
    k_price, k_auct, k_bidder, k_jit = prng.split(key, 4)

    span = cfg.batch_span_ms
    base = float(np.float32(cfg.base_ts)) + torch.arange(b0, b0 + nb, **f32) * span  # [nb]
    offs = torch.arange(B, **f32) * (span / B)
    jitter = prng.uniform(k_jit, B, 0.0, span / B)  # [S, nb, B]
    ts = torch.sort(base[None, :, None] + offs + jitter, dim=-1).values.to(torch.int32)

    lane = torch.arange(B, device=device) % 50
    kind = torch.where(lane == 0, KIND_PERSON, torch.where(lane < 4, KIND_AUCTION, KIND_BID))
    kind = kind.to(torch.int32).expand(S, nb, B).contiguous()
    auction = _auction_ids(cfg, k_auct)
    category = (auction % NUM_CATEGORIES).to(torch.int32)
    price = prng.xla_exp(prng.normal(k_price, B) * 1.0 + 4.0)
    bidder = prng.randint(k_bidder, B, 0, 10_000)

    # skewed load, Bresenham-spread over the batch; the last event is always
    # kept so every partition's watermark reaches the span's end
    frac = prng.pow_f32(p.to(torch.float32) + 1.0, -cfg.skew)  # [S]
    lane_f = torch.arange(B, **f32)
    valid = torch.floor((lane_f + 1.0) * frac[:, None]) > torch.floor(lane_f * frac[:, None])
    valid = (valid | (torch.arange(B, device=device) == B - 1))[:, None, :].expand(S, nb, B)
    return EventBatch(ts, kind, auction, price, category, bidder, valid.contiguous())


def _auction_ids(cfg: NexmarkConfig, key: prng.Key) -> torch.Tensor:
    """Auction ids in ``[0, num_auctions)``: uniform, or under ``key_skew``
    the inverse CDF of the continuous power law ``x^-s`` on ``[1, N+1)``,
    ``id = floor(x) - 1`` (the JAX package's formula, in f32)."""
    B = cfg.events_per_batch
    if cfg.key_skew == 0.0:
        return prng.randint(key, B, 0, cfg.num_auctions)
    N, s = float(cfg.num_auctions), cfg.key_skew
    u = prng.uniform(key, B)
    if s == 1.0:
        x = prng.xla_exp(u * prng.xla_log(torch.tensor(N + 1.0, device=u.device)))
    else:
        x = prng.pow_f32(u * ((N + 1.0) ** (1.0 - s) - 1.0) + 1.0, 1.0 / (1.0 - s))
    return torch.clamp(torch.floor(x) - 1.0, 0.0, N - 1.0).to(torch.int64)


def generate_log(cfg: NexmarkConfig, device="cuda", partitions: range | None = None) -> EventBatch:
    """Input log: EventBatch of ``[len(partitions), num_batches, B]``
    tensors on ``device``, the rows ``partitions`` (by default all
    ``num_partitions``) of the JAX package's ``generate_log(cfg)``.  A row
    depends on its partition id alone, so a rank of a distributed run draws
    its own rows, bitwise those of the whole log."""
    parts = range(cfg.num_partitions) if partitions is None else partitions
    if not (0 <= min(parts, default=0) and max(parts, default=0) < cfg.num_partitions):
        raise ValueError(f"partitions {parts} outside [0, {cfg.num_partitions})")
    shape = (len(parts), cfg.num_batches, cfg.events_per_batch)
    log = None
    for b0 in range(0, cfg.num_batches, CHUNK_BATCHES):
        nb = min(CHUNK_BATCHES, cfg.num_batches - b0)
        chunk = _gen_chunk(cfg, b0, nb, parts, device)
        if log is None:
            log = chunk.map(lambda x: torch.empty(shape, dtype=x.dtype, device=device))
        for f in dataclasses.fields(EventBatch):
            getattr(log, f.name)[:, b0:b0 + nb] = getattr(chunk, f.name)
    return log


def batch_watermark(batch: EventBatch) -> torch.Tensor:
    """Largest valid event time of each partition's batch ``[S, B]`` -> ``[S]``
    (partition-ordered streams: the partition's local watermark after it)."""
    return torch.where(batch.valid, batch.ts, -(2**31)).amax(-1)
