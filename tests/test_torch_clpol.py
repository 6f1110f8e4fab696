"""The port on a small CL&Pol ionic liquid of [C2C1im][DCA]
(``benchmark/layouts/clpol_im21.py`` at its configuration's ``small`` size,
32 ion pairs, wired by ``benchmark/wirings/clpol_im21.py`` as
oplspsffile.py and run-bulk.py build a cell), on the CPU, against the
float64 reference of ``benchmark/references/clpol_im21.py``: the layout's
sites, Drudes, constraints and charge per ion; the forces of each kind of
bonded and molecule term and in total; two middle-scheme steps; and the
readers of the ``terms.dihedral``, ``terms.thole`` and ``terms.exception``
spans."""
import importlib.util
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from openmm_velocityverlet_tpu_torch.ops import term_forces
from benchmark import check
from benchmark.layouts import clpol_im21 as layout
from benchmark.references import clpol_im21 as reference
from benchmark.wirings import clpol_im21 as wiring

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TRAFFIC = dict(recip="exact", segment_steps=100)
# steps from the lattice start before the comparisons: the Drudes leave
# their seeded offsets and the ions their z-matrix shapes
STEPS = 30
# a term kind's force against the reference's autograd, over the root mean
# square of the reference's: the port's float32 coordinate differences round
# at about 2.4e-7 nm in the 3.35-nm box, and its stiffest springs (bonds and
# Drudes, 2.2e5-5.4e5 kJ/mol/nm^2) turn that into 0.05-0.13 kJ/mol/nm against
# a root mean square of 500-700 (2-3.3e-5 read)
KIND_RTOL = 1e-4
# the check's force gap and step gaps at this size (the benchmark's tests
# hold the water and the slab to the same)
FORCE_GAP, STEP_GAP = 5e-4, 1e-3
# the port's term kinds and the reference's terms each one holds
KINDS = {"bond": ("bond",), "angle": ("angle",),
         "dihedral": ("dihedral", "improper"), "drude": ("drude",),
         "thole": ("thole",), "exception": ("exception_coul",
                                            "exception_lj")}
READERS = ("terms.dihedral_ms", "terms.thole_ms", "terms.exception_ms")
# a near-linear angle's force in float32 against float64, relative to the
# force's size: the cross product's sin(theta) holds about 1e-5 at 179.99
# deg, where 1 - cos^2 of a rounded cosine was off by percents
LINEAR_RTOL = 1e-3


def small_config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "clpol_im21.json")) as fh:
        cfg = json.load(fh)
    cfg.update(cfg["small"])
    return cfg


@pytest.fixture(scope="module")
def liquid():
    t = layout.tables(small_config(), 11)
    ctx, system = wiring.build_context(t, TRAFFIC, CPU)
    ctx.step(STEPS)
    return t, ctx, system, reference.build(t, TRAFFIC, CPU)


@pytest.mark.parametrize("ion,sites,drudes,constraints,charge", [
    (0, 27, 8, 11, 1.0), (1, 10, 5, 0, -1.0)])
def test_ion_layout(ion, sites, drudes, constraints, charge):
    cfg = small_config()
    _, tmpls = layout.templates(cfg)
    tmpl = tmpls[ion]
    assert tmpl.n_sites == sites
    assert len(tmpl.drudes) == drudes
    assert len(tmpl.cons) == constraints
    assert tmpl.charge.sum() == pytest.approx(charge, abs=1e-12)
    # each Drude right after its core
    assert all(d == p + 1 for d, p, _, _ in tmpl.drudes)
    t = layout.tables(cfg, 3)
    n = cfg["n_ion_pairs"]
    offsets, sizes = t["ion_sites"].T
    assert list(sizes) == [27] * n + [10] * n
    assert np.array_equal(offsets[1:], np.cumsum(sizes)[:-1])
    mine = t["molecule"] == ion * n
    assert mine.sum() == sites
    assert np.flatnonzero(mine).tolist() == list(range(offsets[ion * n],
                                                       offsets[ion * n]
                                                       + sites))
    # every exclusion, constraint and term lies within one ion
    mol = t["molecule"]
    for key in ("exclusions", "constraints", "bonds", "angles", "torsions",
                "impropers", "pairs14", "thole_pairs", "drudes"):
        rows = t[key].reshape(t[key].shape[0], -1)
        assert np.all(mol[rows] == mol[rows[:, :1]]), key


def _port_kind_forces(system, pos, box, kind):
    """The port's sparse term path on one kind: (energy, forces)."""
    terms, inc, _ = term_forces.build_term_tables(system)
    pick = [k for k, term in enumerate(terms) if term[0] == kind]
    assert len(pick) == 1, kind
    dev_terms, dev_inc = term_forces.tables_to(
        [terms[pick[0]]], [inc[pick[0]]], CPU)
    e, f = term_forces.energies_and_forces(pos, box, dev_terms, dev_inc)
    return sum(float(v) for v in e.values()), f


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_term_kind_forces(liquid, kind):
    t, ctx, system, ref = liquid
    pos, box = ctx.state.pos, ctx.state.box
    e_port, f_port = _port_kind_forces(system, pos, box, kind)
    p = pos.double().requires_grad_(True)
    with torch.enable_grad():
        e = ref.bonded_energy(p)
        e_ref = sum(e[name] for name in KINDS[kind])
        (g,) = torch.autograd.grad(e_ref, p)
    f_ref = -g
    rms = torch.sqrt(torch.mean(torch.sum(f_ref ** 2, 1)))
    assert float(rms) > 0.0
    gap = torch.sqrt(torch.sum((f_port.double() - f_ref) ** 2, 1)).max()
    assert float(gap / rms) < KIND_RTOL, float(gap / rms)
    assert e_port == pytest.approx(float(e_ref.detach()), rel=1e-4, abs=1e-3)


@pytest.mark.parametrize("degrees", [170.0, 179.9, 179.99])
def test_near_linear_angle_force(degrees):
    """One dicyanamide N-C-N angle term (theta0 175.2 deg, 425 kJ/mol/rad^2)
    at ``degrees``, placed off the axes, through the port's analytic angle
    term in float32 against the float64 gradient of its energy."""
    th = math.radians(degrees)
    rot = torch.linalg.qr(torch.tensor([[0.3, -1.2, 0.5], [0.8, 0.1, -0.7],
                                        [-0.4, 0.9, 1.1]],
                                       dtype=torch.float64))[0]
    local = torch.tensor([[0.1157, 0.0, 0.0], [0.0, 0.0, 0.0],
                          [0.131 * math.cos(th), 0.131 * math.sin(th), 0.0]],
                         dtype=torch.float64)
    pos = local @ rot.T + torch.tensor([1.7, 2.3, 0.9], dtype=torch.float64)
    prm = torch.tensor([[math.radians(175.2), 425.0]])
    box = torch.full((3,), 4.0)
    pts = pos.float()[None]
    e, grads = term_forces._angle_ef(
        lambda a, b: term_forces._delta(pts, a, b, box), prm)
    got = torch.stack([torch.cat(g) for g in grads]).double()
    p = pts[0].double().requires_grad_(True)
    u, v = p[0] - p[1], p[2] - p[1]
    theta = torch.atan2(torch.linalg.norm(torch.linalg.cross(u, v)),
                        torch.dot(u, v))
    (want,) = torch.autograd.grad(
        0.5 * 425.0 * (theta - math.radians(175.2)) ** 2, p)
    assert float(torch.abs(got - want).max() / torch.abs(want).max()) \
        < LINEAR_RTOL


def test_total_forces_and_two_steps(liquid):
    t, ctx, system, ref = liquid
    rec = check.record_steps(ctx, 2)
    for k in range(2):
        s = rec["states"][k]
        f_ref, _ = ref.forces(s["pos"], s["box"])
        assert check.worst_atom(ref, rec["forces"][k], f_ref,
                                ref.band)[0] < FORCE_GAP
        gp, gv = check.step_gaps(ref, s, rec["states"][k + 1], f_ref)
        assert gp < STEP_GAP and gv < STEP_GAP
    numbers = ref.numbers(rec["states"][-1])
    assert numbers["drude_nm"] <= ref.dmax
    assert numbers["constraint_rel"] < 1e-4


@pytest.mark.parametrize("name", READERS)
def test_term_span_readers(liquid, name):
    _, ctx, _, _ = liquid
    ctx.step(3)
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "span_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(types.SimpleNamespace())
    assert isinstance(value, float) and math.isfinite(value) and value > 0
