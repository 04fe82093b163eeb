"""device_idle_share: 1 - (union of the device events' intervals in a traced
pass) / (the wall time of an untraced pass), the idle share of a pass as
the window runs it: the profiler slows the host 1.5-2x, and the traced
pass's own wall time would count that as idle (``device.window_s`` keeps
it).  On several cards each rank reads its own card and the harness takes
the mean.  Nothing without device events (a run on the host)."""


def read(r):
    if r.trace is None or r.trace.device_events == 0:
        return None
    return 1.0 - r.trace.busy_s / r.pass_s
