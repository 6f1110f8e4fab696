"""One middle-scheme step captured as a CUDA graph and replayed
(``Context(cuda_graph=True)``).

An eager step launches its several hundred kernels one by one from Python,
and on a system of a few thousand molecules that host work, not the card,
sets the step's time.  Replaying a graph of the step launches them all in
one call, so the step takes the card's time.

The graph reads and writes fixed tensors: the State's evolving tensors
(``KEYS``) and the pair cache it was captured with.  The step's new values
are copied back into those same tensors at the graph's end, so replays
follow one another with no copy between them.  ``load`` hands the graph a
new segment: the Context's State tensors and the segment's fresh pair
cache are copied into the fixed ones, where their shapes match those of
the capture; ``StepGraph.fits`` says whether they do.  The step counter
and the time are host numbers and advance on the host at each replay.

Capture runs the step once eagerly on a side stream (the warm-up torch
asks for, its result dropped), then once under ``torch.cuda.graph``: the
spans inside record CUDA events into the graph (``trace.graph_capture``),
and the kernel counters (``COUNTERS``), which the capture's host pass
moved without a kernel running, are set back and advanced by the
capture's count at every replay, as an eager step would advance them.

What a graph cannot hold is refused when the Context is built
(``blocker``): a host read inside the step (a strict pair sweep's flag,
the iterative constraint solver's convergence test), draws from the
State's generator (Langevin), the barostat's attempt between steps, the
cosine acceleration's host-side amplitude, the VV scheme's force carry and
a mesh's collectives.
"""
from __future__ import annotations

import torch

from . import trace
from .ops import constraints, ewald, ewald_fused, pair_plist, pair_rect, \
    pair_tri

# the State's tensors that a step replaces
KEYS = ("pos", "pos_err", "vel", "nh_eta", "nh_eta_dot", "nh_eta_dotdot")

# the kernel and call counters a step may move: (holder, attribute)
COUNTERS = (
    (pair_plist.plist_pair, "launches"),
    (pair_tri.tri_pair, "launches"),
    (pair_rect.rect_pair, "launches"),
    (ewald.reciprocal_energy, "calls"),
    (ewald.reciprocal_energy, "chunked_calls"),
    (ewald_fused.structure_factor, "launches"),
    (ewald_fused.recip_forces, "launches"),
    (constraints.constraint_clusters, "launches"),
    (constraints.constraint_clusters, "shake_launches"),
    (constraints.constraint_clusters, "rattle_launches"),
)


def blocker(ctx) -> str | None:
    """Why ``ctx``'s step cannot be captured, or None where it can."""
    if ctx.device.type != "cuda":
        return f"a CUDA graph needs a CUDA device, not {ctx.device}"
    if not ctx.data.use_middle:
        return "only the middle scheme is captured (the VV scheme carries " \
               "its forces across steps)"
    if ctx.mesh is not None:
        return "a mesh's steps are not captured"
    if ctx.barostat is not None:
        return "the barostat's attempts read the host between steps"
    if ctx._langevin is not None:
        return "Langevin draws from the State's generator"
    if ctx.data.cos_acceleration != 0:
        return "the cosine acceleration keeps its amplitude on the host"
    if ctx.evaluator.pairs.host_flag:
        return "a strict pair sweep reads its flag on the host"
    if ctx.cons.n_constraints and not ctx.cons.use_clusters:
        return "the iterative constraint solver reads its convergence " \
               "on the host"
    return None


def _fields(cache):
    return () if cache is None else tuple(cache)


def _shape(cache):
    """A cache's layout: each tensor field's shape and dtype, any other
    field's value."""
    return tuple((f.shape, f.dtype) if isinstance(f, torch.Tensor) else f
                 for f in _fields(cache))


def _counts():
    return [getattr(h, a) for h, a in COUNTERS]


class StepGraph:
    """The graph of ``ctx._step_middle(cache)`` and the fixed tensors it
    reads and writes: ``state`` and the captured ``cache``, whose tensors
    later segments' caches are copied into."""

    def __init__(self, ctx, cache):
        st = ctx.state
        self.state = {k: getattr(st, k).clone() for k in KEYS}
        self.cache = cache
        self.refits = ctx.refits
        fixed = st.replace(**self.state)
        dev = ctx.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            ctx.state = fixed
            ctx._step_middle(cache)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        ctx.state = fixed
        try:
            with trace.graph_capture() as events, \
                    torch.cuda.graph(self.graph):
                self.cov = ctx._step_middle(cache)
                out = ctx.state
                for k in KEYS:
                    self.state[k].copy_(getattr(out, k))
        finally:
            ctx.state = st
        self.events = events
        after = _counts()
        self.counts = [b - a for a, b in zip(before, after)]
        for (h, a), v in zip(COUNTERS, before):
            setattr(h, a, v)

    def fits(self, ctx, cache) -> bool:
        """Whether ``cache`` has the captured cache's shapes and the pair
        sweep has not been refitted since the capture."""
        return (ctx.refits == self.refits
                and _shape(cache) == _shape(self.cache))

    def load(self, ctx, cache):
        """The Context's State and ``cache`` into the graph's tensors; the
        Context's State then holds those tensors."""
        if cache is not self.cache:
            for dst, src in zip(_fields(self.cache), _fields(cache)):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
        st = ctx.state
        for k in KEYS:
            src = getattr(st, k)
            if src is not self.state[k]:
                self.state[k].copy_(src)
        ctx.state = st.replace(**self.state)

    def replay(self, ctx):
        """One step; returns the coverage flag (a device bool).  The
        Context's State must hold the graph's tensors (``load``)."""
        self.graph.replay()
        for (h, a), n in zip(COUNTERS, self.counts):
            if n:
                setattr(h, a, getattr(h, a) + n)
        st = ctx.state
        ctx.state = st.replace(step=st.step + 1, time=st.time + ctx.data.dt)
        return self.cov

    def timed(self):
        """The spans' device times of the last replay into the span table,
        once the replay has finished."""
        if self.events:
            self.events[-1][2].synchronize()
        trace.add_replay(self.events)

    def release(self, ctx):
        """The Context's State as tensors of its own, which later replays
        leave alone."""
        st = ctx.state
        ctx.state = st.replace(**{k: getattr(st, k).clone() for k in KEYS})
