"""read_host_ms_per_pass: the host milliseconds of the program's
``holon.read`` spans (every window read after a pass's last fold) summed,
over the ``holon.pass`` spans recorded: in the traced pass, its read.  The
traced pass runs under ``torch.profiler`` with CUDA activity alone, which
slows the host 1.5-2.1x (``PERF.md``).  Nothing where the program records
no spans."""
from holonbench import spans

recorder = spans.recorder


def read(r):
    rec = spans.recorded(r, "read_host_ms_per_pass")
    passes = len(spans.named(rec, "holon.pass"))
    reads = spans.named(rec, "holon.read")
    if not passes or not reads:
        return None
    return sum(s.end_ns - s.start_ns for s in reads) / passes / 1e6
