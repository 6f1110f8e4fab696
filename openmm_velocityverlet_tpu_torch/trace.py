"""Spans: the port's own record of where a step's host time goes.

    from openmm_velocityverlet_tpu_torch import trace
    with trace.span("step.forces"):
        ...

A span does one of two things, chosen when it opens:

* outside a profiler it adds one call and its host-clock duration
  (``time.perf_counter_ns``) to a fixed, process-wide table, which
  ``totals()`` reads.  A name's first call is kept apart as well: it pays
  the kernels' load and the allocator's growth;
* while a torch profiler records, it opens a range on the profiler's
  timeline, where the kernels are, and leaves the table as it is (the
  profiler slows the host several times over, so the table holds
  real-speed time only).  The range is a CPU op
  (``torch._C._profiler._RecordFunctionFast``), not a user annotation
  (``torch.profiler.record_function``): kineto copies a user annotation
  onto the device's timeline as a ``gpu_user_annotation`` spanning the
  kernels launched inside it, which a reader of the trace's device events
  would take for a kernel.  The ``step`` span carries the step number as
  the range's argument (shown where the profiler records shapes).

Every span's name is ``<layer>.<stage>`` (the step itself is ``step``) and
is listed once, in ``SPANS``, with its layer.

A step replayed from a CUDA graph (``Context(cuda_graph=True)``) runs no
host code inside, so its spans cannot read the host's clock.  While the
step is captured (``graph_capture()``) a span records a pair of CUDA
events into the graph instead; after each replay has finished,
``add_replay(events)`` adds each span one call and the device time between
its two events.  Such a span counts the device's time, not the host's:
in a replayed step the host spends none there.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast

# name -> layer, from the entry point down
SPANS = {
    "setup.finalize": "system set-up",      # SystemBuilder.finalize
    "context.init": "context set-up",       # Context.__init__
    "loop.segment": "segment loop",         # one cache segment of step()
    "loop.rebuild": "segment loop",         # a pair-cache rebuild
    "loop.refit": "segment loop",           # a flagged pair list refitted
    "loop.flag_read": "segment loop",       # the coverage flag's host read
    "step": "step",                         # one integrator step
    "step.forces": "step",                  # its force evaluation + extras
    "forces.vsites": "virtual sites",       # placement and redistribution
    "forces.pairs": "pair sweep",           # the direct-space sweep
    "forces.smooth": "reciprocal",          # autograd terms, forward + grad
    "forces.terms": "bonded and molecule terms",
    "terms.dihedral": "bonded and molecule terms",   # torsions, impropers
    "terms.thole": "bonded and molecule terms",      # screened dipole pairs
    "terms.exception": "bonded and molecule terms",  # 1-4 exceptions
    "forces.external": "externals",         # closures with their own force
    "recip.mirror": "reciprocal",           # the mirror route, E and grad
    "step.rattle": "constraints",           # each velocity projection
    "step.shake": "constraints",            # each position solve
    "step.thermostat": "thermostat",        # the TGNH block
    "step.langevin": "thermostat",          # the OU map with its draws
    "step.hardwall": "step",                # the Drude hard wall
    "step.images": "step",                  # the image-charge sync
    "baro.attempt": "barostat",             # one Monte Carlo volume move
    "energy.query": "energy queries",       # Context._energy_query
}

# name -> [calls, total ns, first call's ns]
_table = {name: [0, 0, 0] for name in SPANS}


class Total(NamedTuple):
    """A span's aggregate: its calls, their seconds, the first's seconds."""
    count: int
    total_s: float
    first_s: float

    @property
    def steady_count(self) -> int:
        """The calls after the first."""
        return max(self.count - 1, 0)

    @property
    def steady_s(self) -> float:
        """The seconds of the calls after the first."""
        return self.total_s - self.first_s


def totals() -> dict:
    """A snapshot of the table: {name: Total}, every name of ``SPANS``."""
    return {name: Total(c, t * 1e-9, f * 1e-9)
            for name, (c, t, f) in _table.items()}


# while a step is captured into a CUDA graph: its spans' (row, start event,
# end event), in the order they closed, and the maker of a timing event
_capture = None
_event = None


def _cuda_event():
    """A timing event that a graph capture records as a node of its own."""
    return torch.cuda.Event(enable_timing=True, external=True)


@contextlib.contextmanager
def graph_capture(event=_cuda_event):
    """``with graph_capture() as events:`` around the capture of a CUDA
    graph: every span opened inside records ``event()`` at its start and
    end into the graph, and ``events`` collects (row, start, end) for
    ``add_replay``."""
    global _capture, _event
    events = []
    _capture, _event = events, event
    try:
        yield events
    finally:
        _capture, _event = None, None


def add_replay(events):
    """One replay of a captured graph, finished: each span of ``events``
    gets one call of its events' device time.  While a profiler records,
    the table is left as it is, as for a span run on the host."""
    if torch.autograd._profiler_enabled():
        return
    for row, start, end in events:
        _add(row, int(start.elapsed_time(end) * 1e6))


def _add(row, ns):
    if not row[0]:
        row[2] = ns
    row[0] += 1
    row[1] += ns


class span:
    """``with span(name[, step]):`` -- see the module doc.  ``name`` must
    be a key of ``SPANS``."""
    __slots__ = ("row", "name", "step", "t0", "rf", "ev")

    def __init__(self, name: str, step: int | None = None):
        self.row = _table[name]
        self.name = name
        self.step = step

    def __enter__(self):
        self.ev = None
        if _capture is not None:
            self.rf = None
            self.ev = _event()
            self.ev.record()
        elif torch.autograd._profiler_enabled():
            self.rf = (_RecordFunctionFast(self.name) if self.step is None
                       else _RecordFunctionFast(self.name, (),
                                                {"step": self.step}))
            self.rf.__enter__()
        else:
            self.rf = None
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            end = _event()
            end.record()
            _capture.append((self.row, self.ev, end))
            return False
        if self.rf is not None:
            self.rf.__exit__(*exc)
            return False
        _add(self.row, time.perf_counter_ns() - self.t0)
        return False
