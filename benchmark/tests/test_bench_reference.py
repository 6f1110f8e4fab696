"""The plain reference against the port run on the CPU through its plain
kernel twins, at a small size of each cell: the forces and energies at a
state the port reached, and one middle-scheme step from it; the control
(the reference in float32 with its route's rounding) failing the
comparison; and the smooth-PME route's reference against the exact sum,
its own gradient, and the port's PME route."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import check, reference, run  # noqa: E402
from benchmark.routes import exact, pme  # noqa: E402
from benchmark.tests.test_bench_harness import (  # noqa: E402
    BENCH, CELLS, SMALL_STEPS, config, small, tables, traffic)

# energy terms of the port's energy query and the reference's, relative;
# the energy form of the port's pair sweep takes erfc from a float32
# polynomial, which the excluded pairs at a Drude's short distance amplify
E_RTOL = 1e-4
# the port's float32 step against the float64 reference, at the small size
STEP_GAP = 1e-3


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -12),
                      3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 4 * 2 ** -11, -1.0, 3.0])
    assert torch.equal(reference.tf32(x), want)


def test_ewald_parameters():
    beta, kmax = reference.ewald_parameters(1.2, 5e-4, [4.914] * 3)
    assert beta == pytest.approx(np.sqrt(-np.log(1e-3)) / 1.2)
    assert kmax == (10, 10, 10)


def test_constraint_rounds_share_no_atom():
    pairs = np.array([[0, 1], [0, 2], [1, 2], [3, 4], [3, 5], [4, 5]])
    rounds = reference.colours(pairs, 6)
    assert sorted(np.concatenate(rounds).tolist()) == list(range(6))
    for r in rounds:
        atoms = pairs[r].reshape(-1)
        assert len(set(atoms.tolist())) == atoms.size


def build_reference(workload, t, **kw):
    return run.role("references", config(workload)["reference"]).build(
        t, traffic(workload), torch.device("cpu"), **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(workload):
    t = tables(workload, 9)
    dev = torch.device("cpu")
    ctx, _ = run.role("wirings", config(workload)["wiring"]).build_context(
        t, traffic(workload), dev)
    ctx.step(SMALL_STEPS)
    rec = check.record_steps(ctx, 1)
    ref = build_reference(workload, t)
    s = rec["states"][0]
    f_ref, e_ref = ref.forces(s["pos"], s["box"])
    assert check.worst_atom(ref, rec["forces"][0], f_ref, ref.band)[0] < 5e-4
    gp, gv = check.step_gaps(ref, s, rec["states"][1], f_ref)
    assert gp < STEP_GAP and gv < STEP_GAP
    terms = ctx.evaluator.energy_forces(s["pos"].float(), s["box"].float())[0]
    for name, value in e_ref.items():
        assert float(terms[name]) == pytest.approx(float(value),
                                                   rel=E_RTOL, abs=1e-3), name


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    res = run.run_cell(workload, 4, 0.0, False, device="cpu", control=True,
                       config_override=small(workload), bench=BENCH,
                       min_steps=SMALL_STEPS, log=lambda msg: None)
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    ctl = res["control_readings"]
    gaps = ("force_gap.start", "force_gap.end")
    assert any(ctl[g] > limits[g] for g in gaps)
    assert res["control_correct"] is False
    for g in gaps:
        assert ctl[g] > 3 * res["checks"][g]["value"]


# the PME cell's configuration and route at its small size
PME_CELL = next(w for w in CELLS if traffic(w)["recip"] == "pme")


def melted(seed=9):
    """Tables of the PME cell at its small size and a state the port
    reached after ``SMALL_STEPS`` steps from them (float64 positions and
    box)."""
    t = tables(PME_CELL, seed)
    ctx, _ = run.role("wirings", config(PME_CELL)["wiring"]).build_context(
        t, traffic(PME_CELL), torch.device("cpu"))
    ctx.step(SMALL_STEPS)
    return t, ctx, ctx.state.pos.double(), ctx.state.box.double()


def rel_gap(got, want):
    """The widest row gap over the rows' root mean square."""
    d = torch.sqrt(torch.sum((got - want) ** 2, 1))
    return float(d.max() / torch.sqrt(torch.mean(torch.sum(want ** 2, 1))))


def test_pme_grid_rule():
    assert pme.grid([4.914] * 3) == (50, 50, 50)
    assert pme.grid([1.0, 0.3, 7.7]) == (10, 4, 80)
    # 2/3/5-smooth: 49 and 77 are passed over
    assert pme.grid([4.81, 7.61, 0.15]) == (50, 80, 4)


def test_pme_euler_factors():
    # M_4 at 1, 2, 3 is 1/6, 4/6, 1/6: |b(0)|^2 = 1, and at m = K/2
    # 1 / (1/6 - 4/6 + 1/6)^2 = 9
    b2 = pme.euler_factors(8)
    assert b2[0] == pytest.approx(1.0)
    assert b2[4] == pytest.approx(9.0)
    x = torch.linspace(0.0, 4.0, 401, dtype=torch.float64)
    # M_4 is a partition of unity and sums to 1 over its integer shifts
    total = sum(pme.bspline(x[:100] + j, 4) for j in range(4))
    assert torch.allclose(total, torch.ones(100, dtype=torch.float64))


def test_pme_forces_are_the_gradient():
    t, _, pos, box = melted()
    ref = reference.Reference(t, traffic(PME_CELL), torch.device("cpu"))
    ref.box = box
    p = ref.place_vsites(pos)
    f, e = ref.recip(p)
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(ref.recip(q)[1]["coul_recip"], q)
    assert rel_gap(f, -g) < 1e-10


def test_pme_reference_converges_to_the_exact_sum():
    t, _, pos, box = melted()
    ref = reference.Reference(t, traffic(PME_CELL), torch.device("cpu"))
    ref.box = box
    p = ref.place_vsites(pos)
    # the exact sum far past the tolerance's lattice, so that its own
    # truncation is nowhere near the grids' error
    f_exact, e_exact = exact.Reciprocal(ref, t, kmax=(16, 16, 16))(p)
    gaps, e_gaps = [], []
    for spacing in (0.3, 0.2, 0.1, 0.05):
        f_pme, e_pme = pme.Reciprocal(ref, t, spacing)(p)
        gaps.append(rel_gap(f_pme, f_exact))
        e_gaps.append(abs(float(e_pme["coul_recip"] - e_exact["coul_recip"])))
    assert gaps == sorted(gaps, reverse=True) and gaps[-1] < 0.05 * gaps[0]
    assert e_gaps[-1] < 0.05 * e_gaps[0]
    assert gaps[-1] < 1e-3


def test_port_pme_route_matches_the_reference():
    from openmm_velocityverlet_tpu_torch.ops import pme as port_pme
    t, ctx, pos, box = melted()
    assert ctx.evaluator.pme_grid == pme.grid(t["box"])
    assert port_pme.choose_grid([4.914] * 3) == pme.grid([4.914] * 3)
    ref = reference.Reference(t, traffic(PME_CELL), torch.device("cpu"))
    ref.box = box
    p = ref.place_vsites(pos)
    f_ref, e_ref = ref.recip(p)
    fn = ctx.evaluator.smooth_terms(ctx.state.box)["coul_recip"]
    with torch.enable_grad():
        q = p.float().detach().requires_grad_(True)
        e_port = fn(q)
        (g,) = torch.autograd.grad(e_port, q)
    assert rel_gap(-g.double(), f_ref) < 1e-4
    assert float(e_port.detach()) == pytest.approx(
        float(e_ref["coul_recip"]), rel=1e-5)


def test_pme_control_rounds_to_bf16():
    t, _, pos, box = melted()
    ref = reference.Reference(t, traffic(PME_CELL), torch.device("cpu"))
    ref.box = box
    p = ref.place_vsites(pos)
    f_ref = ref.recip(p)[0]
    ctl = reference.Reference(t, traffic(PME_CELL), torch.device("cpu"),
                              dtype=torch.float32, control=True)
    ctl.box = box.float()
    f_ctl = ctl.recip(p.float())[0].double()
    plain = reference.Reference(t, traffic(PME_CELL), torch.device("cpu"),
                                dtype=torch.float32)
    plain.box = box.float()
    f32 = plain.recip(p.float())[0].double()
    # bf16's 8-bit mantissa against float32's 24: the control's gap is
    # orders above plain float32's
    assert rel_gap(f_ctl, f_ref) > 100 * rel_gap(f32, f_ref)
    x = torch.tensor([1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9, 3.0])
    assert torch.equal(pme.bf16(x), torch.tensor([1.0, 1.0 + 4 * 2 ** -9,
                                                  3.0]))
