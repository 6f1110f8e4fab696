"""Seconds of ``Context.__init__``: the mean of the port's ``context.init``
span (one Context a run), on the host's clock.  None where the port has
no spans."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()["context.init"]
    return t.total_s / t.count if t.count else None
