"""Milliseconds of the smooth terms of a force evaluation, forward and
``autograd.grad`` (in this cell the matmul reciprocal alone): the mean of
the port's ``forces.smooth`` span over its calls after the first, outside
the profiler, on the host's clock.  The in-step counterpart of
``recip.route_ms``.  None where the port has no spans."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()["forces.smooth"]
    return 1e3 * t.steady_s / t.steady_count if t.steady_count else None
