"""Training-side use of the windowed CRDTs (port of ``repro.training``).

Only the metrics lattice is ported so far; the optimizer, the train and
serve steps and checkpointing come with the LM stack."""
from repro_torch.training.metrics import (
    MetricSpec,
    metrics_axis_join,
    metrics_fold,
    metrics_init,
    metrics_merge,
    metrics_read,
)

__all__ = [
    "MetricSpec",
    "metrics_init",
    "metrics_fold",
    "metrics_merge",
    "metrics_axis_join",
    "metrics_read",
]
