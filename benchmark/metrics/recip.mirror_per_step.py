"""Calls of the reciprocal's mirror route a step: the port's
``recip.mirror`` span's calls over its ``step`` span's, each span's first
call left out, outside the profiler.  A step evaluates the route once, so
this reads 1 and a little more (the check's and ``recip.route_ms``'s
evaluations outside the steps); 0 where the cell takes the explicit
route over every row.  None where the port has no such span."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    steps = t["step"].steady_count
    mirror = t.get("recip.mirror")
    if not steps or mirror is None:
        return None
    return mirror.steady_count / steps
