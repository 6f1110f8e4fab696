"""Milliseconds of the smooth terms of a force evaluation, forward and
``autograd.grad``, in a cell whose images take the mirror route (the
route over the real rows, the images' structure factor from their
parents'): the mean of the port's ``forces.smooth`` span over its calls
after the first, outside the profiler, on the host's clock.  None where
the port has no spans."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()["forces.smooth"]
    return 1e3 * t.steady_s / t.steady_count if t.steady_count else None
