"""delta_merge_join_roofline: the fused merge side of a delta-sync round's
share of its roofline, in %, over the traced pass.

The recorder wraps the program's ``kernels/crdt_merge.delta_merge_join``
and keeps each launch's tensors' shapes and its ``[R, W]`` stack of tenant
wids, from which the rows the gate lets in are counted after the window.
The bound is each launch's bytes (``holonbench/roofline.py``, ``PERF.md``
section 6 row 6) at 3.35 TB/s, or its joins at the f32 peak where those
take longer; the time is the union of its device events' intervals.
"""
import contextlib

import torch

from holonbench import roofline

KERNELS = ("delta_merge_join_kernel",)


def _shape(t: torch.Tensor) -> torch.Tensor:
    """A tensor's shape and dtype, without its data."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


@contextlib.contextmanager
def recorder():
    from repro_torch.kernels import crdt_merge

    launches = []
    launch = crdt_merge.delta_merge_join

    def recorded(state_wid, stack_wid, state_leaves, stack_leaves, joins, state_meta,
                 stack_meta):
        launches.append((_shape(state_wid), stack_wid, [_shape(t) for t in state_leaves],
                         [_shape(t) for t in state_meta], [_shape(t) for t in stack_meta]))
        return launch(state_wid, stack_wid, state_leaves, stack_leaves, joins, state_meta,
                      stack_meta)

    crdt_merge.delta_merge_join = recorded
    try:
        yield launches
    finally:
        crdt_merge.delta_merge_join = launch


def read(r):
    launches = r.records.get("delta_merge_join_roofline")
    if not launches or r.trace is None:
        return None
    t = r.trace.kernel_s(*KERNELS)
    if t == 0.0:
        return None
    rows = roofline.gated_rows(torch.stack([w for _, w, *_ in launches])).tolist()
    bound = 0.0
    for (state_wid, stack_wid, leaves, meta, stack_meta), n in zip(launches, rows):
        bound += roofline.bound_s(
            roofline.delta_merge_join_bytes(state_wid, stack_wid, leaves, meta, stack_meta, n),
            roofline.delta_merge_join_ops(leaves, n))
    return 100.0 * bound / t
