"""Launch-time model flags (the port's own copy of ``repro.models.flags``).

TP_PAD: attention head counts are padded up to a multiple of this value so
the head axis shards evenly over the ``model`` mesh axis.  Pad heads are
masked dead weight: zero-initialized, output-masked, provably zero-gradient
(DESIGN.md §6) — model math is exactly the published architecture.  Set to
the model-axis size by launchers/dry-run (16); defaults to 1 (no padding) so
smoke tests see unpadded shapes.
"""
_TP_PAD = 1
_BATCH_AXES: tuple = ("pod", "data")


def set_tp_pad(n: int) -> None:
    global _TP_PAD
    _TP_PAD = max(1, int(n))


def tp_pad() -> int:
    return _TP_PAD


def pad_heads(h: int) -> int:
    p = _TP_PAD
    return ((h + p - 1) // p) * p


def set_batch_axes(axes: tuple) -> None:
    """ZeRO-3 strategy folds the model axis into the batch (pure DP)."""
    global _BATCH_AXES
    _BATCH_AXES = tuple(axes)


def batch_axes() -> tuple:
    return _BATCH_AXES
