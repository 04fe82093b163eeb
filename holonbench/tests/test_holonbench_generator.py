"""The benchmark's frozen generator draws, bit for bit, the program's log:
every field, uniform and zipf auction ids, partition skew, a seed above
2**31, and one rank's rows alone."""
import dataclasses

import pytest
import torch

from holonbench.nexmark.generator import FIELDS, LogSpec, generate
from repro_torch.streaming.generator import NexmarkConfig, generate_log

SPECS = [
    LogSpec(num_partitions=4, num_batches=70, events_per_batch=100, rate_per_partition=625_000.0,
            seed=2**31 + 9, num_auctions=1_000_000, key_skew=1.1),
    LogSpec(num_partitions=3, num_batches=5, events_per_batch=64, rate_per_partition=10_000.0,
            seed=0, skew=1.0, num_auctions=10_000, key_skew=1.1),
    LogSpec(num_partitions=2, num_batches=3, events_per_batch=50, rate_per_partition=1_000.0,
            seed=12345, num_auctions=1000),
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows", [None, (1, 2)])
def test_generator_copy_is_the_programs(spec, rows):
    parts = None if rows is None else range(*rows)
    got = generate(spec, "cpu", parts)
    want = generate_log(NexmarkConfig(**dataclasses.asdict(spec)), "cpu", partitions=parts)
    assert set(got) == set(FIELDS)
    for f in FIELDS:
        a, b = got[f], getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
