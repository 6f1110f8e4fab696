"""The port on a small constant-voltage slab of SWM4-NDP water and Drude
NaCl between fixed graphite electrodes (``benchmark/layouts/
edl_swm4_nacl.py`` at its configuration's ``small`` size, wired by
``benchmark/wirings/edl_swm4_nacl.py`` as run-edl wires a cell), on the
CPU: the images on their parents' mirror after 20 steps, in the stored
rows and after placement, the M sites' images included; the fixed
electrode's rows bitwise unchanged; and the E-field's share on a virtual
site carried by its parents, so that a water feels no net field force."""
import json
import os
import types

import numpy as np
import pytest
import torch

from openmm_velocityverlet_tpu_torch.integrators import stepping
from benchmark.layouts import edl_swm4_nacl as layout
from benchmark.wirings import edl_swm4_nacl as wiring

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 20
# a few float32 ulps of the box's height: the rounding of a mirrored z and
# of a placed site
MIRROR_ATOL = 4e-6


def slab_tables(seed=7):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "edl_swm4_nacl.json")) as fh:
        cfg = json.load(fh)
    cfg.update(cfg["small"])
    return layout.tables(cfg, seed)


def slab_context(t, voltage_v=1.0):
    return wiring.build_context(t, dict(recip="exact", voltage_v=voltage_v),
                                torch.device("cpu"))[0]


@pytest.fixture(scope="module")
def stepped():
    t = slab_tables()
    ctx = slab_context(t)
    start = ctx.state.pos.clone()
    ctx.step(STEPS)
    return t, ctx, start


def _mirror_gap(t, pos, placed):
    """The widest distance of an image row of ``pos`` from the mirror of its
    parent's row of ``placed``."""
    par, img = t["image_pairs"][:, 0], t["image_pairs"][:, 1]
    want = placed[par] * torch.tensor([1.0, 1.0, -1.0]) + torch.tensor(
        [0.0, 0.0, 2.0 * t["mirror_nm"]])
    return float(torch.linalg.norm(pos[img] - want, dim=1).max())


def test_images_sit_on_their_parents_mirror(stepped):
    t, ctx, _ = stepped
    assert ctx.image_mirror is not None
    assert ctx.current_step == STEPS
    placed = ctx.evaluator.place_vsites(ctx.state.pos)
    assert _mirror_gap(t, placed, placed) < MIRROR_ATOL
    # the stored rows too: an M site's image mirrors the site's placement,
    # not its stale stored row
    assert _mirror_gap(t, ctx.state.pos, placed) < MIRROR_ATOL
    m_rows = t["vsites"][:t["vsites"].size // 2]
    assert not torch.equal(ctx.state.pos[m_rows], placed[m_rows])


def test_fixed_electrode_keeps_its_rows(stepped):
    t, ctx, start = stepped
    elec = torch.as_tensor(t["electrode"])
    assert torch.equal(ctx.state.pos[elec], start[elec])
    assert torch.all(ctx.state.vel[elec] == 0)
    # the liquid moved
    liq = torch.as_tensor(t["liquid"])
    assert not torch.equal(ctx.state.pos[liq], start[liq])


def test_field_on_virtual_sites_moves_to_their_parents():
    t = slab_tables()
    ctx = slab_context(t)
    field = ctx._efield[:, 2].double()
    assert torch.all(field[torch.as_tensor(t["vsites"])] == 0)
    e_z = 1.0 * 2.0 / t["box"][2] * 96.4853400990037
    # a water is neutral: no net force along the field; an ion feels q E
    liq = t["liquid"]
    mol = torch.as_tensor(t["molecule"][liq])
    net = torch.zeros(int(mol.max()) + 1, dtype=torch.float64).index_add_(
        0, mol, field[torch.as_tensor(liq)])
    n_w = t["vsites"].size // 2
    assert float(net[:n_w].abs().max()) < 1e-5 * e_z
    np.testing.assert_allclose(net[n_w:].abs().numpy(), e_z, rtol=1e-5)
    # and the liquid's total is sum q E over its rows, the M sites' too
    q = torch.as_tensor(t["charges"][t["liquid"]], dtype=torch.float64)
    np.testing.assert_allclose(float(field.sum()), float(q.sum()) * e_z,
                               atol=1e-4)
    # an O core's row is its own q E and its share of its M site's
    o = t["vsite_parents"][0, 0]
    m = t["vsites"][0]
    w_o = t["vsite_weights"][0, 0]
    np.testing.assert_allclose(
        float(field[o]), (t["charges"][o] + w_o * t["charges"][m]) * e_z,
        rtol=1e-5)


def test_a_local_frame_site_is_refused():
    system = types.SimpleNamespace(
        vsite_index=np.array([3]), vsite_parents=np.array([[0, 1, 2]]),
        vsite_origin_w=np.array([[1.0, 0.0, 0.0]]),
        vsite_local=np.array([[0.0, 0.0, 0.01]]))
    field = np.array([1.0, 0.0, 0.0, -1.0], np.float32)
    with pytest.raises(ValueError):
        stepping.vsite_field_to_parents(field, system)
    with pytest.raises(ValueError):
        stepping.image_site_tables(system, [[4, 3]], "cpu")
    # an uncharged site, or one with no image, passes
    field[3] = 0.0
    assert stepping.vsite_field_to_parents(field, system) is field
    assert stepping.image_site_tables(system, [[4, 2]], "cpu") is None


def test_slab_wiring_matches_its_tables():
    t = slab_tables()
    system = wiring.build_system(t)
    np.testing.assert_array_equal(np.asarray(system.charges),
                                  t["charges"].astype(np.float32))
    np.testing.assert_array_equal(np.asarray(system.masses),
                                  t["masses"].astype(np.float32))
    excl = np.asarray(system.exclusions)
    got = {(i, int(j)) for i, row in enumerate(excl) for j in row
           if j >= 0 and i < j}
    want = {tuple(sorted(map(int, p))) for p in t["exclusions"]}
    assert got == want
