"""Milliseconds a step of the constraint solvers: the port's
``step.rattle`` and ``step.shake`` spans over its ``step`` span's calls,
each span's first call left out, outside the profiler, on the host's
clock.  None where the port has no spans."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    steps = t["step"].steady_count
    if not steps:
        return None
    return 1e3 * (t["step.rattle"].steady_s + t["step.shake"].steady_s) / steps
