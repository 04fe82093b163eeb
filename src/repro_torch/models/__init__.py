"""The LM stack (port of ``repro.models``): init, train-forward, prefill
and decode of every family."""
from repro_torch.models.common import shard
from repro_torch.models.lm import (
    _cache_spec as cache_spec,
    decode_step,
    forward_loss,
    init_params,
    pad_cache,
    prefill,
    prefill_encdec,
)

__all__ = [
    "decode_step",
    "forward_loss",
    "init_params",
    "prefill",
    "prefill_encdec",
    "cache_spec",
    "pad_cache",
    "shard",
]
