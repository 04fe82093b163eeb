"""Training (port of ``repro.training``): AdamW, the train step,
the serve and prefill steps, decentralized checkpoints and the WCRDT
metrics lattice."""
from repro_torch.training.metrics import (
    MetricSpec,
    metrics_axis_join,
    metrics_fold,
    metrics_init,
    metrics_merge,
    metrics_read,
)
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.training.train_step import make_prefill_step, make_serve_step, make_train_step

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "make_train_step",
    "make_serve_step",
    "make_prefill_step",
    "MetricSpec",
    "metrics_init",
    "metrics_fold",
    "metrics_merge",
    "metrics_axis_join",
    "metrics_read",
]
