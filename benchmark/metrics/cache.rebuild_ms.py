"""Milliseconds of a pair-cache rebuild (``Context._fresh_cache``, with its
overflow read and any refit): the mean of the port's ``loop.rebuild`` span
over its calls after the first, outside the profiler, on the host's clock.
None where the port has no spans."""


def read(r):
    try:
        from openmm_velocityverlet_tpu_torch.trace import totals
    except ImportError:
        return None
    t = totals()["loop.rebuild"]
    return 1e3 * t.steady_s / t.steady_count if t.steady_count else None
