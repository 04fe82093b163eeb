"""The benchmark's Nexmark log: a frozen copy of ``repro_torch/streaming/generator.py``.

It draws, on the device and from the seed, the very log the program's
``generate_log`` draws for the same parameters (held bitwise by
``holonbench/tests/test_holonbench_generator.py``): batch ``b`` of partition
``p`` from ``fold_in(fold_in(PRNGKey(seed), p), b)`` split in four.  Per
partition, ``rate_per_partition`` events a second of event time, batches of
``events_per_batch`` with timestamps evenly spaced over the batch span plus
jitter, then sorted; the Nexmark mix of 1 person : 3 auctions : 46 bids per
50 events; lognormal(4, 1) prices; auction ids uniform over
``num_auctions``, or zipf-like under ``key_skew``; ``category = auction %
5``; and the ``skew`` validity pattern of partition load.

A row depends on its partition id alone, so a rank draws only its own rows.
The result is a dict of ``[len(partitions), num_batches, events_per_batch]``
tensors, field by field as the program's ``EventBatch`` holds them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from holonbench.nexmark import prng

KIND_PERSON, KIND_AUCTION, KIND_BID = 0, 1, 2
FIELDS = ("ts", "kind", "auction", "price", "category", "bidder", "valid")
NUM_CATEGORIES = 5  # Nexmark default category count
CHUNK_BATCHES = 64  # batches drawn per pass (bounds the int64 temporaries)


@dataclasses.dataclass(frozen=True)
class LogSpec:
    """The parameters of a log, named as the program's ``NexmarkConfig``."""

    num_partitions: int
    num_batches: int
    events_per_batch: int
    rate_per_partition: float  # events / second of event time
    seed: int
    skew: float = 0.0  # zipf exponent of partition load (0: every event valid)
    num_auctions: int = 1000  # auction ids in [0, num_auctions)
    key_skew: float = 0.0  # zipf exponent of auction ids (0: uniform)
    base_ts: int = 0

    @property
    def batch_span_ms(self) -> float:
        return 1000.0 * self.events_per_batch / self.rate_per_partition


def _chunk(spec: LogSpec, b0: int, nb: int, parts: range, device) -> dict:
    S, B = len(parts), spec.events_per_batch
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    p = torch.arange(parts.start, parts.stop, parts.step, **i64)
    key = prng.fold_in(prng.prng_key(spec.seed, device), p[:, None])
    key = prng.fold_in(key, torch.arange(b0, b0 + nb, **i64)[None, :])  # [S, nb]
    k_price, k_auct, k_bidder, k_jit = prng.split(key, 4)

    span = spec.batch_span_ms
    base = float(np.float32(spec.base_ts)) + torch.arange(b0, b0 + nb, **f32) * span
    offs = torch.arange(B, **f32) * (span / B)
    jitter = prng.uniform(k_jit, B, 0.0, span / B)  # [S, nb, B]
    ts = torch.sort(base[None, :, None] + offs + jitter, dim=-1).values.to(torch.int32)

    lane = torch.arange(B, device=device) % 50
    kind = torch.where(lane == 0, KIND_PERSON, torch.where(lane < 4, KIND_AUCTION, KIND_BID))
    kind = kind.to(torch.int32).expand(S, nb, B).contiguous()
    auction = _auction_ids(spec, k_auct)
    category = (auction % NUM_CATEGORIES).to(torch.int32)
    price = prng.xla_exp(prng.normal(k_price, B) * 1.0 + 4.0)
    bidder = prng.randint(k_bidder, B, 0, 10_000)

    # skewed load, Bresenham-spread over the batch; the last event is always
    # kept so every partition's watermark reaches the span's end
    frac = prng.pow_f32(p.to(torch.float32) + 1.0, -spec.skew)  # [S]
    lane_f = torch.arange(B, **f32)
    valid = torch.floor((lane_f + 1.0) * frac[:, None]) > torch.floor(lane_f * frac[:, None])
    valid = (valid | (torch.arange(B, device=device) == B - 1))[:, None, :].expand(S, nb, B)
    return dict(ts=ts, kind=kind, auction=auction, price=price, category=category,
                bidder=bidder, valid=valid.contiguous())


def _auction_ids(spec: LogSpec, key) -> torch.Tensor:
    """Uniform ids, or under ``key_skew`` the inverse CDF of the continuous
    power law ``x^-s`` on ``[1, N+1)``, ``id = floor(x) - 1``, in f32."""
    B = spec.events_per_batch
    if spec.key_skew == 0.0:
        return prng.randint(key, B, 0, spec.num_auctions)
    N, s = float(spec.num_auctions), spec.key_skew
    u = prng.uniform(key, B)
    if s == 1.0:
        x = prng.xla_exp(u * prng.xla_log(torch.tensor(N + 1.0, device=u.device)))
    else:
        x = prng.pow_f32(u * ((N + 1.0) ** (1.0 - s) - 1.0) + 1.0, 1.0 / (1.0 - s))
    return torch.clamp(torch.floor(x) - 1.0, 0.0, N - 1.0).to(torch.int64)


def generate(spec: LogSpec, device, partitions: range | None = None) -> dict:
    """The rows ``partitions`` (by default all) of the log, on ``device``."""
    parts = range(spec.num_partitions) if partitions is None else partitions
    if not (0 <= min(parts, default=0) and max(parts, default=0) < spec.num_partitions):
        raise ValueError(f"partitions {parts} outside [0, {spec.num_partitions})")
    shape = (len(parts), spec.num_batches, spec.events_per_batch)
    log = None
    for b0 in range(0, spec.num_batches, CHUNK_BATCHES):
        nb = min(CHUNK_BATCHES, spec.num_batches - b0)
        chunk = _chunk(spec, b0, nb, parts, device)
        if log is None:
            log = {f: torch.empty(shape, dtype=x.dtype, device=device) for f, x in chunk.items()}
        for f, x in chunk.items():
            log[f][:, b0:b0 + nb] = x
    return log
