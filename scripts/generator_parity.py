#!/usr/bin/env python3
"""Where the port's generator and q4 oracle differ from the JAX package's (CPU).

  JAX_PLATFORMS=cpu PYTHONPATH=src python3 scripts/generator_parity.py

Prints one JSON line: the lanes of 2^20 where ``prng.pow_f32`` and XLA's
``pow`` differ (x^-10, the zipf exponent at ``key_skew=1.1``) and by how
many ulp; the fields of a 4 x 64 x 4,096 log that differ from the JAX
``generate_log`` at ``key_skew`` 0, 1 and 1.1 over 10^6 ids, lane counts;
and how many of the q4 oracle's window/category averages differ from the
JAX oracle's (bitwise) on four small logs, with the largest relative gap.
"""
from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import torch

from repro.streaming import generator as jgen
from repro.streaming import queries as jq
from repro_torch.convert import event_batch_from_numpy
from repro_torch.streaming import generator, prng
from repro_torch.streaming import queries as tq


def main() -> None:
    out = {}
    x = np.random.default_rng(5).uniform(0.25, 1.0, 1 << 20).astype(np.float32)
    ulp = np.abs(prng.pow_f32(torch.from_numpy(x), -10.0).numpy().view(np.int32).astype(np.int64)
                 - np.asarray(jnp.asarray(x) ** -10.0).view(np.int32).astype(np.int64))
    out["pow_x^-10"] = {"lanes": x.size, "differ": int((ulp != 0).sum()), "max_ulp": int(ulp.max())}

    fields = [f.name for f in dataclasses.fields(jgen.EventBatch)]
    for key_skew in (0.0, 1.0, 1.1):
        kw = dict(num_partitions=4, num_batches=64, events_per_batch=4096, seed=3, skew=1.5,
                  key_skew=key_skew, num_auctions=1_000_000)
        jlog = jgen.generate_log(jgen.NexmarkConfig(**kw))
        log = generator.generate_log(generator.NexmarkConfig(**kw), device="cpu")
        out[f"log_key_skew={key_skew}"] = {
            f: int((np.asarray(getattr(jlog, f)).astype(np.float64)
                    != getattr(log, f).numpy().astype(np.float64)).sum()) for f in fields}

    n = differ = 0
    gap = 0.0
    for S, nb, b, rate in ((3, 4, 200, 20_000.0), (2, 8, 64, 10_000.0), (4, 16, 1024, 10_000.0),
                           (8, 32, 4096, 100_000.0)):
        jlog = jgen.generate_log(jgen.NexmarkConfig(num_partitions=S, num_batches=nb,
                                                    events_per_batch=b, rate_per_partition=rate))
        plog = event_batch_from_numpy({f: np.asarray(getattr(jlog, f)) for f in fields})
        jq4, pq4 = jq.make_q4(S, window_len=10), tq.make_q4(S, window_len=10)
        for wid in range(12):
            want = np.asarray(jq4.oracle(jlog, jnp.int32(wid)))
            got = pq4.oracle(plog, wid).numpy()
            n += want.size
            differ += int((want != got).sum())
            gap = max(gap, float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))))
    out["q4_oracle"] = {"averages": n, "differ": differ, "max_rel_gap": gap}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
