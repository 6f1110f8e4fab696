"""The port's spans (``openmm_velocityverlet_tpu_torch/trace.py``) on the
64-molecule drude_water box (Drude pairs, two constraints a molecule, the
hard wall, exact-k Ewald) under TGNH in the middle scheme, on the CPU:
the spans' ranges and their nesting under torch.profiler, with no user
annotation among them; the host-clock aggregates outside the profiler,
against the Context's own counters, and still under it; the same
positions and velocities with and without a profiler recording; the
benchmark's six readers of the aggregates; the spans of the analytic
externals and of the mirror route, entered on a small constant-voltage
slab (``tests/test_torch_slab.py``) and not on the water, with the four
readers of the slab's cell; and the span names, each listed once in
``trace.SPANS`` and used in the package's code."""
import importlib.util
import math
import os
import re
import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu_torch import trace
from openmm_velocityverlet_tpu_torch.models.drude_water import drude_water_box
from openmm_velocityverlet_tpu_torch.units import BOLTZ
from tests.test_torch_slice import _drude_positions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "openmm_velocityverlet_tpu_torch")
N_MOL = 64
# the spans of this system's step path, each with the span nearest above
# it on the profiler's timeline
PARENT = {
    "loop.segment": None,
    "loop.rebuild": "loop.segment",
    "loop.flag_read": "loop.segment",
    "step": "loop.segment",
    "step.forces": "step",
    "step.rattle": "step",
    "step.shake": "step",
    "step.thermostat": "step",
    "step.hardwall": "step",
    "forces.vsites": "step.forces",
    "forces.pairs": "step.forces",
    "forces.smooth": "step.forces",
    "forces.terms": "step.forces",
}
READERS = ("setup.context_s", "cache.rebuild_ms", "step.forces_ms",
           "forces.terms_ms", "recip.step_ms", "step.constraints_ms")


def _context(**kw):
    ps, pos, box = drude_water_box(N_MOL)
    integ = tpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
    integ.setMaxDrudeDistance(0.02)
    pos = _drude_positions(pos, seed=3)
    ctx = tpkg.Context(ps, integ, positions=pos, box=box, device="cpu", **kw)
    rng = np.random.default_rng(5)
    ctx.set_velocities((rng.normal(0, 1, pos.shape) * np.sqrt(
        BOLTZ * 333.0 * np.asarray(ps.inv_masses))[:, None]
        ).astype(np.float32))
    return ctx


def _counters(ctx):
    return dict(rebuilds=ctx.rebuilds, refits=ctx.refits,
                host_syncs=ctx.host_syncs)


def _span_parent(ev):
    """The name of the nearest span above a profiler event, or None."""
    ev = ev.cpu_parent
    while ev is not None and ev.name not in trace.SPANS:
        ev = ev.cpu_parent
    return None if ev is None else ev.name


def test_spans_nest_on_the_profiler_timeline():
    ctx = _context()
    ctx.step(1)
    first = ctx.current_step
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        ctx.step(3)
    spans = [e for e in prof.events() if e.name in trace.SPANS]
    assert set(Counter(e.name for e in spans)) == set(PARENT)
    steps = [e for e in spans if e.name == "step"]
    assert len(steps) == 3
    assert sorted(e.kwinputs["step"] for e in steps) == [
        first, first + 1, first + 2]
    for e in spans:
        assert _span_parent(e) == PARENT[e.name], e.name
    # CPU ops, which kineto does not copy onto the device's timeline
    assert not any(e.is_user_annotation for e in spans)


def test_aggregates_count_outside_the_profiler():
    ctx = _context(sort_refresh=2)
    ctx.step(1)
    a0, c0 = trace.totals(), _counters(ctx)
    ctx.step(5)
    a1, c1 = trace.totals(), _counters(ctx)

    def calls(name):
        return a1[name].count - a0[name].count
    d = {k: c1[k] - c0[k] for k in c0}
    assert calls("step") == 5
    assert calls("loop.rebuild") == d["rebuilds"] - d["refits"] >= 3
    # the plist loop's host reads: one a rebuild, one a step's flag
    assert calls("loop.flag_read") == d["host_syncs"] - d["rebuilds"] == 5
    for name in PARENT:
        assert a1[name].total_s > a0[name].total_s, name
        assert a1[name].first_s == a0[name].first_s, name
    ctx.potential_energy()
    a2 = trace.totals()
    assert a2["energy.query"].count == a1["energy.query"].count + 1
    assert a2["step"] == a1["step"]
    with profile(activities=[ProfilerActivity.CPU]):
        ctx.step(2)
        ctx.potential_energy()
    assert trace.totals() == a2


def test_profiler_leaves_the_arithmetic_alone():
    plain, traced = _context(), _context()
    plain.step(4)
    with profile(activities=[ProfilerActivity.CPU]):
        traced.step(4)
    for name in ("pos", "pos_err", "vel"):
        assert torch.equal(getattr(plain.state, name),
                           getattr(traced.state, name)), name


@pytest.fixture(scope="module")
def stepped():
    ctx = _context(sort_refresh=3)
    ctx.step(7)
    return ctx


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_aggregates(name, stepped):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "span_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(types.SimpleNamespace())
    assert isinstance(value, float) and math.isfinite(value) and value > 0


# spans entered only where their mechanism runs: the analytic externals
# and the reciprocal's mirror route
SLAB_SPANS = ("forces.external", "recip.mirror")
SLAB_READERS = ("step.images_ms", "forces.external_ms", "recip.mirror_ms",
                "recip.mirror_per_step")


@pytest.fixture(scope="module")
def slab():
    from tests.test_torch_slab import slab_context, slab_tables
    return slab_context(slab_tables())


def _calls(before, after):
    return {name: after[name].count - before[name].count
            for name in SLAB_SPANS + ("step",)}


def test_slab_spans_run_on_a_slab_only(slab):
    water = _context()
    a0 = trace.totals()
    water.step(3)
    a1 = trace.totals()
    slab.step(3)
    a2 = trace.totals()
    assert _calls(a0, a1) == {"step": 3, "forces.external": 0,
                              "recip.mirror": 0}
    # one force evaluation a step of the middle scheme
    assert _calls(a1, a2) == {"step": 3, "forces.external": 3,
                              "recip.mirror": 3}


@pytest.mark.parametrize("name", SLAB_READERS)
def test_slab_reader_reads_the_aggregates(name, slab):
    slab.step(3)
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "span_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(types.SimpleNamespace())
    assert isinstance(value, float) and math.isfinite(value) and value > 0


def test_span_names_are_listed_and_used():
    used = Counter()
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            # trace.py's own doc shows a span
            if f.endswith(".py") and f != "trace.py":
                with open(os.path.join(dirpath, f)) as fh:
                    used.update(re.findall(r'trace\.span\("([^"]+)"',
                                           fh.read()))
    assert set(used) == set(trace.SPANS)
    # forces.vsites wraps the placement and the redistribution
    assert {k: n for k, n in used.items() if n > 1} == {"forces.vsites": 2}
    for name in trace.SPANS:
        assert name == "step" or re.fullmatch(r"[a-z]+\.[a-z_]+", name)
    with pytest.raises(KeyError):
        trace.span("step.nothing")
