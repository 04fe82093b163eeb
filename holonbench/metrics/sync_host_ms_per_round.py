"""sync_host_ms_per_round: the mean host milliseconds of the program's
``holon.sync.round`` spans in the traced pass, one a sync round: the dense
path's delta (or full) merge of every spec, the keyed path's gated
watermark ``pmax``.  The traced pass runs under ``torch.profiler`` with
CUDA activity alone, which slows the host 1.5-2.1x (``PERF.md``).
Nothing where the program records no spans."""
from holonbench import spans

recorder = spans.recorder


def read(r):
    return spans.mean_ms(spans.recorded(r, "sync_host_ms_per_round"), "holon.sync.round")
