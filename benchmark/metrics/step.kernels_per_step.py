"""Kernels the device ran per step, counted in torch.profiler's trace of
the profiled sub-window."""


def read(r):
    if r.profile is None:
        return None
    return r.profile["kernels"] / r.profile["steps"]
