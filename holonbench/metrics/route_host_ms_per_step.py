"""route_host_ms_per_step: the mean host milliseconds of the program's
``holon.fold.route`` spans in the traced pass, one a keyed fold step: the
owner of every lane, the ``[L, S, B]`` routing stack and the mesh's
``all_to_all`` (on one card its transpose).  The traced pass runs under
``torch.profiler`` with CUDA activity alone, which slows the host 1.5-2.1x
(``PERF.md``).  Nothing on a path without routing, or without spans."""
from holonbench import spans

recorder = spans.recorder


def read(r):
    return spans.mean_ms(spans.recorded(r, "route_host_ms_per_step"), "holon.fold.route")
