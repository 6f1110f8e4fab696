"""The step replayed from a CUDA graph (``Context(cuda_graph=True)``,
``openmm_velocityverlet_tpu_torch/step_graph.py``): what a graph cannot
hold is refused at construction, with its reason; spans opened while a
step is captured record events instead of the host's clock, and each
finished replay adds their device time to the span table; on a card, the
replayed steps of the small CL&Pol liquid against its eager steps,
bitwise, with the kernel counters, the cache rebuilds and the spans.  The
card's cases skip without one (marker ``cuda``)."""
import json
import os
import types

import numpy as np
import pytest
import torch

from openmm_velocityverlet_tpu_torch import Context, step_graph, trace
from openmm_velocityverlet_tpu_torch.ops import constraints, pair_plist
from benchmark.layouts import clpol_im21 as layout
from benchmark.wirings import clpol_im21 as wiring
from benchmark.wirings import swm4_ndp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAFFIC = dict(recip="exact", segment_steps=100)
CARD = pytest.mark.skipif(not torch.cuda.is_available(),
                          reason="a CUDA graph needs a card")


def small_tables(seed=11):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "clpol_im21.json")) as fh:
        cfg = json.load(fh)
    cfg.update(cfg["small"])
    return layout.tables(cfg, seed)


def capturable(**changes):
    """A stand-in for a Context whose step a graph can hold, ``changes``
    applied: the fields ``step_graph.blocker`` reads."""
    ctx = types.SimpleNamespace(
        device=torch.device("cuda"),
        data=types.SimpleNamespace(use_middle=True, cos_acceleration=0.0),
        mesh=None, barostat=None, _langevin=None,
        evaluator=types.SimpleNamespace(
            pairs=types.SimpleNamespace(host_flag=False)),
        cons=types.SimpleNamespace(n_constraints=4, use_clusters=True))
    for path, value in changes.items():
        obj = ctx
        *parents, name = path.split(".")
        for p in parents:
            obj = getattr(obj, p)
        setattr(obj, name, value)
    return ctx


@pytest.mark.parametrize("path,value,words", [
    ("device", torch.device("cpu"), "CUDA device"),
    ("data.use_middle", False, "middle scheme"),
    ("mesh", object(), "mesh"),
    ("barostat", object(), "barostat"),
    ("_langevin", {}, "Langevin"),
    ("data.cos_acceleration", 0.02, "cosine acceleration"),
    ("evaluator.pairs.host_flag", True, "strict pair sweep"),
    ("cons.use_clusters", False, "iterative constraint solver"),
])
def test_blocker_names_what_a_graph_cannot_hold(path, value, words):
    assert step_graph.blocker(capturable()) is None
    assert words in step_graph.blocker(capturable(**{path: value}))


def test_no_constraints_need_no_clusters():
    assert step_graph.blocker(capturable(**{
        "cons.n_constraints": 0, "cons.use_clusters": False})) is None


def test_cuda_graph_refused_on_the_host():
    t = small_tables()
    system = wiring.build_system(t)
    with pytest.raises(ValueError, match="cuda_graph: .*CUDA device"):
        Context(system, swm4_ndp.build_integrator(t),
                positions=t["positions"], box=t["box"], cuda_graph=True,
                device="cpu")


class StubEvent:
    """A timing event on a fake clock: ``record`` reads the next tick."""
    clock = [0]

    def __init__(self):
        self.at = None

    def record(self):
        self.at = StubEvent.clock[0]

    def elapsed_time(self, end):
        return end.at - self.at                   # ms


def test_captured_spans_record_events_and_replays_add_them():
    before = trace.totals()
    StubEvent.clock[0] = 0
    with trace.graph_capture(StubEvent) as events:
        with trace.span("forces.terms"):
            StubEvent.clock[0] = 2
            with trace.span("terms.thole"):
                StubEvent.clock[0] = 3
            StubEvent.clock[0] = 7
    # the capture itself adds nothing
    assert trace.totals() == before
    assert [row for row, _, _ in events] == [
        trace._table["terms.thole"], trace._table["forces.terms"]]
    for _ in range(3):
        trace.add_replay(events)
    after = trace.totals()
    for name, ms in (("forces.terms", 7.0), ("terms.thole", 1.0)):
        a, b = before[name], after[name]
        assert b.count - a.count == 3
        assert b.total_s - a.total_s == pytest.approx(3 * ms * 1e-3)
        if a.count == 0:
            assert b.first_s == pytest.approx(ms * 1e-3)
    # outside a capture a span reads the host's clock again
    with trace.span("terms.thole"):
        pass
    assert trace.totals()["terms.thole"].count == after["terms.thole"].count + 1


def _card_contexts(seed=5):
    t = small_tables(seed)
    system = wiring.build_system(t)
    out = []
    for graph in (False, True):
        ctx = Context(system, swm4_ndp.build_integrator(t),
                      positions=t["positions"], box=t["box"],
                      cuda_graph=graph, sort_refresh=9, device="cuda")
        ctx.set_velocities(t["velocities"])
        out.append(ctx)
    return out


@pytest.mark.cuda
@CARD
def test_replayed_steps_are_the_eager_steps():
    eager, graph = _card_contexts()
    counts = []
    for ctx in (eager, graph):
        c0 = (pair_plist.plist_pair.launches,
              constraints.constraint_clusters.shake_launches,
              trace.totals()["terms.thole"].count)
        for n in (1, 7, 25):
            ctx.step(n)
        torch.cuda.synchronize()
        counts.append((pair_plist.plist_pair.launches - c0[0],
                       constraints.constraint_clusters.shake_launches - c0[1],
                       trace.totals()["terms.thole"].count - c0[2],
                       ctx.rebuilds, ctx.coverage_rebuilds,
                       ctx.host_syncs))
    assert graph._graph is not None and eager._graph is None
    for k in step_graph.KEYS:
        assert torch.equal(getattr(eager.state, k), getattr(graph.state, k)), k
    assert graph.state.step == eager.state.step == 33
    assert graph.state.time == eager.state.time
    # each capture's warm-up runs the step once more on the card, eagerly
    e, g = counts
    extra = g[0] - e[0]
    assert extra >= 1 and e[0] == 33
    assert g[1] - e[1] == extra * e[1] // 33
    assert g[2] - e[2] == extra * e[2] // 33
    assert g[3:] == e[3:]
    # the State is the Context's own: another step leaves it alone
    pos = graph.state.pos
    kept = pos.clone()
    graph.step(1)
    assert torch.equal(pos, kept)
    assert not torch.equal(graph.state.pos, kept)


@pytest.mark.cuda
@CARD
def test_new_positions_reach_the_graph():
    eager, graph = _card_contexts(6)
    for ctx in (eager, graph):
        ctx.step(4)
        ctx.set_positions(ctx.get_positions())
        ctx.set_velocities(np.asarray(ctx.get_velocities()) * 0.5)
        ctx.step(4)
    for k in step_graph.KEYS:
        assert torch.equal(getattr(eager.state, k), getattr(graph.state, k)), k
