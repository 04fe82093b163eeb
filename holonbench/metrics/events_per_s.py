"""events_per_s: the events of all the window's whole passes over their
time on the host clock, which ends in a device synchronise (on several
cards, the slowest rank's time)."""


def read(r) -> float:
    return r.events / r.window_s
