"""The share of a step in which the device runs nothing: one less the
profiled sub-window's device-busy seconds per step over the unprofiled
window's wall seconds per step."""


def read(r):
    if r.profile is None or not r.steps:
        return None
    busy = r.profile["busy_s"] / r.profile["steps"]
    return 100.0 * (1.0 - busy / (r.window_s / r.steps))
