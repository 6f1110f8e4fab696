"""The plain reference against the port run on the CPU through its plain
kernel twins, at a small size of each cell: the forces and energies at a
state the port reached, and one middle-scheme step from it; and the
control (the reference in float32 with TF32 products) failing the
comparison."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import check, port, reference, run  # noqa: E402
from benchmark.tests.test_bench_harness import (  # noqa: E402
    BENCH, SMALL, SMALL_STEPS, tables, traffic)

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


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_reference_agrees_with_the_port(workload):
    t = tables(workload, 9)
    dev = torch.device("cpu")
    ctx, _ = port.build_context(t, traffic(workload), dev)
    ctx.step(SMALL_STEPS)
    rec = check.record_steps(ctx, 1)
    ref = reference.Reference(t, dev)
    s = rec["states"][0]
    f_ref, e_ref = ref.forces(s["pos"], s["box"])
    assert check.worst_atom(ref, rec["forces"][0], f_ref, ref.band)[0] < 5e-4
    gp, gv = check.step_gaps(ref, s, rec["states"][1], f_ref)
    assert gp < STEP_GAP and gv < STEP_GAP
    terms = ctx.evaluator.energy_forces(s["pos"].float(), s["box"].float())[0]
    for name, value in e_ref.items():
        assert float(terms[name]) == pytest.approx(float(value),
                                                   rel=E_RTOL, abs=1e-3), name


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails(workload):
    res = run.run_cell(workload, 4, 0.0, False, device="cpu", control=True,
                       config_override=SMALL[workload], bench=BENCH,
                       min_steps=SMALL_STEPS, log=lambda msg: None)
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    ctl = res["control_readings"]
    gaps = ("force_gap.start", "force_gap.end")
    assert any(ctl[g] > limits[g] for g in gaps)
    for g in gaps:
        assert ctl[g] > 3 * res["checks"][g]["value"]
