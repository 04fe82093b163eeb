"""fold_idle_ms_per_step: the card's idle milliseconds in the traced pass
that fall inside the program's ``holon.fold.step`` spans (or a span inside
one), over the count of those spans: the card waiting on the step loop.
Each gap between the device events of the traced pass is put down to the
innermost span open at its midpoint (``holonbench/spans.py``).  The traced
pass runs under ``torch.profiler`` with CUDA activity alone, which slows
the host 1.5-2.1x (``PERF.md``), so the card waits longer there than in
an untraced pass.  Nothing without device events or spans."""
from holonbench import spans

recorder = spans.recorder


def read(r):
    rec = spans.recorded(r, "fold_idle_ms_per_step")
    steps = len(spans.named(rec, spans.STEP))
    if not steps or r.trace is None or r.trace.device_events == 0:
        return None
    inside = spans.within(rec, spans.STEP)
    idle = sum(s for i, s in spans.idle_by_span(r.trace, rec).items() if i >= 0 and inside[i])
    return idle * 1e3 / steps
