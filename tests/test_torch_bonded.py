"""The closed-form term energies (ops/bonded.py, ops/drude.py) against the
JAX package's, on the same numpy inputs: energies at rtol 2e-5, angles at
2e-5 rad; the port's hand-derived term forces (ops/term_forces.py) against
torch.autograd.grad of these energies at the JAX package's
force-vs-gradient tolerance (tests/test_smoke.py:50-51: rtol 2e-4, atol
2e-3).  Systems: __graft_entry__._drude_system's polarizable water, the
polarizable dumbbell fluid of tests/test_tgnh.py, the CHARMM fixture of
chip_smoke.write_charmm_fixture through both packages' loaders (bonds,
Drude pairs and CMAP), and tests/test_torch_terms.py's four-atom chains,
the one with Urey-Bradley terms, dihedrals, impropers, an anisotropic
Drude spring and Thole pairs, which the other three lack."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu.ops import bonded as jb
from openmm_velocityverlet_tpu.ops import drude as jd
from openmm_velocityverlet_tpu_torch.models.grofile import GroFile
from openmm_velocityverlet_tpu_torch.ops import bonded as tb
from openmm_velocityverlet_tpu_torch.ops import cmap as tcmap
from openmm_velocityverlet_tpu_torch.ops import drude as td
from openmm_velocityverlet_tpu_torch.ops import term_forces as ttf
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from tests.test_tgnh import make_polarizable_dumbbell_fluid
from tests.test_torch_loaders import _load_both
from tests.test_torch_terms import _rich_system

E_RTOL = 2e-5
F_RTOL, F_ATOL = 2e-4, 2e-3
SYSTEMS = ("drude_water", "dumbbell", "charmm_fixture", "chains")


def _system(kind, tmp_path):
    """(JAX System, port System, float32 positions, float32 box)."""
    rng = np.random.default_rng(4)
    if kind == "drude_water":
        import __graft_entry__ as ge
        ctx = ge._drude_system(n_mol=8)
        js, pos, box = ctx.system, np.asarray(ctx.state.pos), \
            np.asarray(ctx.state.box)
        # Drude particles start on their cores: move them off
        pos = pos + rng.normal(0, 0.01, pos.shape)
        ps = system_from_numpy(js)
    elif kind == "dumbbell":
        js, pos, box = make_polarizable_dumbbell_fluid()
        ps = system_from_numpy(js)
    elif kind == "charmm_fixture":
        psf_p, prm_p, gro_p = chip_smoke.write_charmm_fixture(
            str(tmp_path), 2)
        gro = GroFile(gro_p)
        mine, ref = _load_both(psf_p, prm_p, gro.box)
        js, ps, pos, box = ref.system, mine.system, gro.positions, gro.box
    else:
        js, pos, box = _rich_system(jpkg.SystemBuilder)
        ps, _, _ = _rich_system(tpkg.SystemBuilder)
    return js, ps, np.array(pos, np.float32), np.array(box, np.float32)


def _energies(mod, s, pos, box):
    """Every energy of the two modules on one package's System view."""
    out = dict(mod[0].bonded_energy(s, pos, box))
    out["drude"] = mod[1].drude_spring_energy(
        pos, box, s.drude_pairs, s.drude_k3, s.drude_k1, s.drude_k2,
        s.drude_aniso)
    out["thole"] = mod[1].thole_energy(pos, box, s.thole_sites, s.thole_qq,
                                       s.thole_screen)
    return out


@pytest.mark.parametrize("kind", SYSTEMS)
def test_term_energies_match_jax(kind, tmp_path):
    js, ps, pos, box = _system(kind, tmp_path)
    t = ps.to("cpu")
    pt, bt = torch.tensor(pos), torch.tensor(box)
    pj, bj = jnp.asarray(pos), jnp.asarray(box)
    e_j = jax.jit(lambda p, b: _energies((jb, jd), js, p, b))(pj, bj)
    e_t = _energies((tb, td), t, pt, bt)
    assert set(e_t) == set(e_j)
    for k in e_j:
        np.testing.assert_allclose(float(e_t[k]), float(e_j[k]),
                                   rtol=E_RTOL, atol=1e-5, err_msg=k)
    # the per-function pieces: the gather and the signed dihedral angle
    idx = np.asarray(js.bonds).reshape(-1, 2)[:, 0]
    np.testing.assert_array_equal(
        tb._gather(pt, torch.as_tensor(idx)).numpy(),
        np.asarray(jb._gather(pj, jnp.asarray(idx))))
    for rows in (js.dihedrals, js.impropers, np.asarray(
            js.cmap_atoms).reshape(-1, 8)[:, :4]):
        rows = np.asarray(rows).reshape(-1, 4)
        if rows.shape[0]:
            np.testing.assert_allclose(
                tb._dihedral_angle(pt, bt, torch.as_tensor(rows)).numpy(),
                np.asarray(jb._dihedral_angle(pj, bj, jnp.asarray(rows))),
                rtol=0, atol=2e-5)
    if kind == "chains":
        # the only system that carries every term
        assert all(float(e_j[k]) != 0.0 for k in e_j)


@pytest.mark.parametrize("kind", [k for k in SYSTEMS if k != "dumbbell"])
def test_term_forces_match_autograd(kind, tmp_path):
    """The analytic forces the step takes, without the 1-4 exceptions
    (their energies are not in these modules), against the gradient of
    bonded + Drude spring + Thole.  Not on the dumbbell fluid: its bond of
    k = 2e5 kJ/mol/nm^2 sits at its rest length, where one float32 ulp of
    the bond length (1.5e-8 nm) is 3e-3 kJ/mol/nm of force, beyond the
    tolerance's atol for the analytic form and the float64 gradient
    alike."""
    _, ps, pos, box = _system(kind, tmp_path)
    t = ps.to("cpu")
    bt = torch.as_tensor(box)
    n_exc = np.asarray(ps.exc_idx).size
    terms, inc, _ = ttf.build_term_tables(
        ps, exc_keep_mask=np.zeros(n_exc, bool))
    e_a, f_a = ttf.energies_and_forces(torch.as_tensor(pos), bt,
                                       *ttf.tables_to(terms, inc, "cpu"))
    p = torch.as_tensor(pos).requires_grad_(True)
    e = _energies((tb, td), t, p, bt)
    (g,) = torch.autograd.grad(sum(e.values()), p)
    np.testing.assert_allclose(f_a.numpy(), -g.numpy(), rtol=F_RTOL,
                               atol=F_ATOL)
    for k, v in e_a.items():
        np.testing.assert_allclose(float(v), float(e[k].detach()),
                                   rtol=E_RTOL,
                                   atol=1e-4, err_msg=k)


def test_dihedral_angle_is_the_cmap_angle(tmp_path):
    """The CMAP term takes its angles from ops/bonded (as the JAX cmap
    does); on the fixture's cross-terms they agree with a float64 numpy
    evaluation of the signed dihedral."""
    assert tcmap.dihedral_angle is tb._dihedral_angle
    _, ps, pos, box = _system("charmm_fixture", tmp_path)
    rows = np.asarray(ps.cmap_atoms).reshape(-1, 8)
    rows = np.concatenate([rows[:, :4], rows[:, 4:]])
    got = tcmap.dihedral_angle(torch.as_tensor(pos), torch.as_tensor(box),
                               torch.as_tensor(rows)).numpy()
    p = np.asarray(pos, np.float64)
    b = np.asarray(box, np.float64)

    def mi(d):
        return d - b * np.round(d / b)
    b1 = mi(p[rows[:, 1]] - p[rows[:, 0]])
    b2 = mi(p[rows[:, 2]] - p[rows[:, 1]])
    b3 = mi(p[rows[:, 3]] - p[rows[:, 2]])
    n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
    m1 = np.cross(n1, b2 / np.linalg.norm(b2, axis=1, keepdims=True))
    want = np.arctan2((m1 * n2).sum(1), (n1 * n2).sum(1))
    assert rows.shape[0] == 16
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
