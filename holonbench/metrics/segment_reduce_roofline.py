"""segment_reduce_roofline: the sorted segment reduce's share of its
roofline, in %, over the traced pass.

The recorder wraps the program's ``kernels/segment_reduce.reduce_sorted``
(the launch; the sort runs before it and is not the kernel's) and keeps each
launch's shapes and a view of its sorted stream's last tile edge, the count
of live lanes, read after the window.  The bound is each launch's bytes
(``holonbench/roofline.py``: what the three kernels read and write, without
the mask that the sort reads) at 3.35 TB/s, or
its operations at the f32 peak where those take longer; the time is the
union of the intervals of the kernel's device events (its three kernels
overlap by programmatic dependent launch).
"""
import contextlib

import torch

from holonbench import roofline

KERNELS = ("segment_front_kernel", "segment_hot_kernel", "segment_span_kernel")


@contextlib.contextmanager
def recorder():
    from repro_torch.kernels import segment_reduce as seg

    launches = []
    launch = seg.reduce_sorted

    def recorded(sseg, sval, edges, n_seg, op="sum", init=None):
        launches.append((n_seg, edges.shape[0], init is not None, edges[-1:]))
        return launch(sseg, sval, edges, n_seg, op=op, init=init)

    seg.reduce_sorted = recorded
    try:
        yield launches
    finally:
        seg.reduce_sorted = launch


def read(r):
    launches = r.records.get("segment_reduce_roofline")
    if not launches or r.trace is None:
        return None
    t = r.trace.kernel_s(*KERNELS)
    if t == 0.0:
        return None
    live = torch.cat([e for *_, e in launches]).tolist()
    bound = sum(roofline.bound_s(roofline.segment_reduce_bytes(n_seg, n_edges, init, lv),
                                 roofline.segment_reduce_ops(n_seg, lv))
                for (n_seg, n_edges, init, _), lv in zip(launches, live))
    return 100.0 * bound / t
