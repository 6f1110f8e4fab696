"""Milliseconds a step of the external closures that bring their own force
(here the Drude wall): the port's ``forces.external`` span over its
``step`` span's calls, each span's first call left out, outside the
profiler, on the host's clock.  None where the port has no such span."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    steps = t["step"].steady_count
    external = t.get("forces.external")
    if not steps or external is None or not external.steady_count:
        return None
    return 1e3 * external.steady_s / steps
