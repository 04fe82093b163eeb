"""device_events_per_step: device events (kernels, copies, fills) of the
traced pass over its fold steps: what the eager host loops of
``launch/stream`` enqueue for one batch."""


def read(r):
    if r.trace is None or r.trace.device_events == 0:
        return None
    return r.trace.device_events / r.steps
