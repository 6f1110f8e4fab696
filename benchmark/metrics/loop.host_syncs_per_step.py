"""Host reads of device values per step of the measured window: the
segment loop's coverage-flag reads, the pair-list overflow reads of its
cache rebuilds and the barostat's reads (``Context.host_syncs``)."""


def read(r):
    if not r.steps:
        return None
    return r.counters["host_syncs"] / r.steps
