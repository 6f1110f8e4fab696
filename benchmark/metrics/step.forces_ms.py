"""Milliseconds a step of the step's force evaluation (its
``energy_forces`` call and extra forces): the port's ``step.forces`` span
over its ``step`` span's calls, each span's first call left out, outside
the profiler, on the host's clock.  None where the port has no spans."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    steps = t["step"].steady_count
    return 1e3 * t["step.forces"].steady_s / steps if steps else None
