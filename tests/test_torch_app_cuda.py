"""A checkpoint resume on the card: run_bulk's simulation on chip_smoke's
243-atom fixture (Langevin on every particle, so the generator state
matters), a checkpoint at step 20, and a fresh simulation built by run_bulk
with ``--cpt`` stepped over the same 30 steps, a window with no barostat
attempt (every 100 steps; the checkpoint does not carry the barostat's
state): positions within 1e-4 nm of the run, the generator state equal.
The step's pair kernel (B1) has no CPU mode, so this skips on a machine
without a card; tests/test_torch_app.py holds the same round trip bitwise
on the CPU.  Imports no jax: the card's machine has none (run it there with
``python -m pytest --noconftest tests/test_torch_app_cuda.py``)."""
import numpy as np
import pytest
import torch

import chip_smoke
from openmm_velocityverlet_tpu_torch.examples import run_bulk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's pair kernel B1 has no "
                    "CPU mode")
    return "cuda"


def test_checkpoint_resume_on_the_card(cuda, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    psf, prm, gro = chip_smoke.write_charmm_fixture(str(tmp_path), 3,
                                                    by_species=True)
    cli = ["--gro", gro, "--psf", psf, "--prm", prm]
    sim = run_bulk.simulation_from_args(run_bulk.parser.parse_args(cli),
                                        device=cuda)
    sim.step(20)
    sim.save_checkpoint("cpt.cpt_20")
    sim.step(30)
    pos = sim.context.get_positions()
    gen = sim.context.state.generator.get_state()
    resumed = run_bulk.simulation_from_args(
        run_bulk.parser.parse_args(cli + ["--cpt", "cpt.cpt_20"]),
        device=cuda)
    assert resumed.current_step == 20
    resumed.step(30)
    assert np.abs(resumed.context.get_positions() - pos).max() < 1e-4
    assert torch.equal(resumed.context.state.generator.get_state(), gen)
    assert np.isfinite(list(
        resumed.context.potential_energy_terms().values())).all()
