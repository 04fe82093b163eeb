"""Training (port of ``repro.training``): AdamW, the train step,
decentralized checkpoints and the WCRDT metrics lattice.  The serve and
prefill steps come with the serving path."""
from repro_torch.training.metrics import (
    MetricSpec,
    metrics_axis_join,
    metrics_fold,
    metrics_init,
    metrics_merge,
    metrics_read,
)
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.training.train_step import make_train_step

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "make_train_step",
    "MetricSpec",
    "metrics_init",
    "metrics_fold",
    "metrics_merge",
    "metrics_axis_join",
    "metrics_read",
]
