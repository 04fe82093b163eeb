"""The LM stack (port of ``repro.models``): the training path of every
family (serving is ROADMAP Queue 1, item 3)."""
from repro_torch.models.common import shard
from repro_torch.models.lm import forward_loss, init_params

__all__ = ["forward_loss", "init_params", "shard"]
