"""The LM stack (port of ``repro.models``): the dense family's training
path so far."""
from repro_torch.models.common import shard
from repro_torch.models.lm import forward_loss, init_params

__all__ = ["forward_loss", "init_params", "shard"]
