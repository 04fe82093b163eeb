"""fold_host_ms_per_step: the mean host milliseconds of the program's
``holon.fold.step`` spans in the traced pass, one a fold step: the eager
loop's batch (the log's slices, the fold's torch ops, the kernels'
launches; on the keyed path its routing too).  The traced pass runs under
``torch.profiler`` with CUDA activity alone, which slows the host 1.5-2.1x
(``PERF.md``), so this is a traced step's time.  Nothing where the program
records no spans."""
from holonbench import spans

recorder = spans.recorder


def read(r):
    return spans.mean_ms(spans.recorded(r, "fold_host_ms_per_step"), spans.STEP)
