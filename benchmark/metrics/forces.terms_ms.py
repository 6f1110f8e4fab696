"""Milliseconds of the bonded and molecule terms of a force evaluation
(``term_forces`` and ``mol_terms``): the mean of the port's
``forces.terms`` span over its calls after the first, outside the
profiler, on the host's clock.  None where the port has no spans."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()["forces.terms"]
    return 1e3 * t.steady_s / t.steady_count if t.steady_count else None
