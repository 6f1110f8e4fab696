"""Milliseconds a step of the torsions and impropers (the dihedral kind of
the bonded and molecule terms): the port's ``terms.dihedral`` span over its
``step`` span's calls, each span's first call left out, outside the
profiler, on the host's clock.  None where the port has no such span or the
cell no such terms."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    steps = t["step"].steady_count
    span = t.get("terms.dihedral")
    if not steps or span is None or not span.steady_count:
        return None
    return 1e3 * span.steady_s / steps
