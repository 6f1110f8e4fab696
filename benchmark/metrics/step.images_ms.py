"""Milliseconds a step of the image-charge sync: the port's ``step.images``
span over its ``step`` span's calls, each span's first call left out,
outside the profiler, on the host's clock.  None where the port has no
spans or the cell no images."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    steps = t["step"].steady_count
    images = t.get("step.images")
    if not steps or images is None or not images.steady_count:
        return None
    return 1e3 * images.steady_s / steps
