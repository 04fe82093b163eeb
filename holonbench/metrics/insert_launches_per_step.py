"""insert_launches_per_step: the launches of the program's one-launch ring
bookkeeping (``kernels/ring_insert``, reached through
``wcrdt.insert(owned=True)``) in the traced pass, over its fold steps: how often
the dense fold step takes the in-place path, one launch a counter spec a
step.  The keyed fold bypasses it and reads 0.

The recorder reads the kernel's launch counter (``CudaKernel.launches`` in
``kernels/ops.KERNELS``) before and after the pass.  Nothing where the
program has no such kernel."""
import contextlib

NAME = "ring_insert"


@contextlib.contextmanager
def recorder():
    from repro_torch.kernels import ops

    kernel = ops.KERNELS.get(NAME)
    rec = {}
    start = None if kernel is None else kernel.launches
    try:
        yield rec
    finally:
        if kernel is not None:
            rec["launches"] = kernel.launches - start


def read(r):
    rec = r.records.get("insert_launches_per_step")
    if not rec or r.trace is None:
        return None
    return rec["launches"] / r.steps
