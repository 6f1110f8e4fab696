"""The port's alternative force terms against the JAX package's on the same
numpy inputs: NBTHOLE (ops/nonbonded.py), CMAP (ops/cmap.py) and GB
(ops/gb.py), each with its autograd forces against jax.grad, and the
ForceEvaluator of a system carrying each of them against the JAX
ForceEvaluator on the dense sweep."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu.forces import ForceEvaluator as JFE
from openmm_velocityverlet_tpu.ops import cmap as jcmap
from openmm_velocityverlet_tpu.ops import gb as jgb
from openmm_velocityverlet_tpu.ops import nonbonded as jnb
from openmm_velocityverlet_tpu.ops.bonded import _dihedral_angle
from openmm_velocityverlet_tpu_torch.forces import ForceEvaluator as TFE
from openmm_velocityverlet_tpu_torch.models.drude_water import drude_water_box
from openmm_velocityverlet_tpu_torch.ops import cmap as tcmap
from openmm_velocityverlet_tpu_torch.ops import gb as tgb
from openmm_velocityverlet_tpu_torch.ops import nonbonded as tnb
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from openmm_velocityverlet_tpu_torch.units import ONE_4PI_EPS0
from tests.test_cmap import _pentane_like
from tests.test_gb import _cluster, _gbdata
from tests.test_torch_pair import assert_forces_close

E_RTOL = 1e-5


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _grad_close(g_t, g_j, rel=1e-4):
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(np.asarray(g_t), g_j,
                               atol=rel * np.abs(g_j).max())


def _port_value_and_grad(fn, pos):
    p = _t(pos).requires_grad_(True)
    e = fn(p)
    (g,) = torch.autograd.grad(e, p)
    return float(e.detach()), g.numpy()


# ------------------------------------------------------------------ NBTHOLE
def _two_dipoles(pkg):
    """tests/test_nbthole.py:20-61's system: two Drude dipoles of
    different NBTHOLE types."""
    b = pkg.SystemBuilder()
    b.add_particle(14.0, charge=1.2, lj_type=0)
    b.add_particle(0.4, charge=-1.2, lj_type=0)
    b.add_particle(12.0, charge=0.9, lj_type=0)
    b.add_particle(0.4, charge=-0.9, lj_type=0)
    b.set_lj_from_type_params([0.3], [0.0])
    b.add_drude(1, 0, -1, -1, -1, -1.2, 1.0e-3, 1.0, 1.0)
    b.add_drude(3, 2, -1, -1, -1, -0.9, 1.5e-3, 1.0, 1.0)
    b.add_exclusion(0, 1)
    b.add_exclusion(2, 3)
    coef = np.zeros((3, 3))
    coef[1, 2] = coef[2, 1] = 2.6
    b.set_nbthole([1, 1, 2, 2], [1.0, 1.0] + [1.5 ** (-1 / 6)] * 2, coef)
    box = np.array([5.0, 5.0, 5.0])
    return b.finalize(box, r_cutoff=1.2, use_pme=False), box


def _same_type(pkg):
    """tests/test_nbthole.py:64-77's system: one type, an exclusion."""
    b = pkg.SystemBuilder()
    for q in (1.0, -1.0, 1.0, -1.0):
        b.add_particle(10.0, charge=q, lj_type=0)
    b.set_lj_from_type_params([0.3], [0.0])
    b.add_exclusion(0, 2)
    b.set_nbthole([1, 1, 1, 1], [1.0] * 4, np.array([[0, 0], [0, 2.6]]))
    box = np.array([5.0, 5.0, 5.0])
    return b.finalize(box, r_cutoff=1.2, use_pme=False), box


def _nbthole_port(system, pos, box, rc):
    tables = tnb.nbthole_tables(system.nbt_idx, system.nbt_alpha,
                                system.nbt_coef, system.charges,
                                system.exclusions, "cpu")
    return _port_value_and_grad(
        lambda p: tnb.nbthole_energy(p, _t(box), tables, rc), pos)


def _nbthole_jax(system, pos, box, rc):
    return jax.value_and_grad(lambda p: jnb.nbthole_energy(
        p, jnp.asarray(box, jnp.float32), system.nbt_idx, system.nbt_alpha,
        system.nbt_coef, system.charges, system.exclusions, rc))(
            jnp.asarray(pos, jnp.float32))


def test_nbthole_two_dipoles_matches_analytic_and_jax():
    """Four site-site terms with the screen 2.6 (a1 a2)^(-1/6) 10: the
    analytic sum and the JAX energy (rtol 1e-5), forces against
    jax.grad."""
    ps, box = _two_dipoles(tpkg)
    js, _ = _two_dipoles(jpkg)
    pos = np.array([[1.0, 1.0, 1.0], [1.02, 1.0, 1.0],
                    [1.5, 1.0, 1.0], [1.53, 1.0, 1.0]], np.float32)
    e_t, g_t = _nbthole_port(ps, pos, box, 1.2)
    e_j, g_j = _nbthole_jax(js, pos, box, 1.2)
    screen = 2.6 * 1.5 ** (-1 / 6) * 10.0
    expect = 0.0
    for i, qi in ((0, 1.2), (1, -1.2)):
        for j, qj in ((2, 0.9), (3, -0.9)):
            r = float(np.linalg.norm(pos[i] - pos[j]))
            sr = screen * r
            expect += (-ONE_4PI_EPS0 * qi * qj * (1.0 + 0.5 * sr)
                       * math.exp(-sr) / r)
    np.testing.assert_allclose(e_t, expect, rtol=E_RTOL)
    np.testing.assert_allclose(e_t, float(e_j), rtol=E_RTOL)
    _grad_close(g_t, g_j)


def test_nbthole_same_type_and_exclusions_inert():
    ps, box = _same_type(tpkg)
    pos = np.array([[1, 1, 1], [1.3, 1, 1], [1.6, 1, 1], [1.9, 1, 1]],
                   np.float32)
    e_t, g_t = _nbthole_port(ps, pos, box, 1.2)
    assert e_t == 0.0 and not g_t.any()


@pytest.mark.parametrize("block_elems", [1 << 24, 200])
def test_nbthole_random_types_match_jax(block_elems, monkeypatch):
    """60 active atoms of three types (and 20 inert ones) with random
    exclusions across the periodic boundary, in one block and cut into
    row blocks of 3 rows: energy rtol 1e-5, forces atol 1e-4 max|F|."""
    rng = np.random.default_rng(4)
    n = 80
    b = jpkg.SystemBuilder()
    for i in range(n):
        b.add_particle(12.0, charge=float(rng.normal(0, 0.5)), lj_type=0)
    b.set_lj_from_type_params([0.3], [0.0])
    for _ in range(40):
        i, j = rng.choice(n, 2, replace=False)
        b.add_exclusion(int(i), int(j))
    idx = np.where(np.arange(n) < 60, 1 + np.arange(n) % 3, 0)
    coef = np.zeros((4, 4))
    coef[1, 2] = coef[2, 1] = 2.6
    coef[1, 3] = coef[3, 1] = 1.9
    coef[2, 3] = coef[3, 2] = 2.2
    b.set_nbthole(idx, rng.uniform(0.7, 1.1, n), coef)
    box = np.array([1.6, 1.7, 1.8])
    js = b.finalize(box, r_cutoff=0.9, use_pme=False)
    ps = system_from_numpy(js)
    pos = (rng.uniform(0, 1, (n, 3)) * box).astype(np.float32)
    monkeypatch.setattr(tnb, "NBTHOLE_BLOCK_ELEMS", block_elems)
    e_t, g_t = _nbthole_port(ps, pos, box, 0.5)
    e_j, g_j = _nbthole_jax(js, pos, box, 0.5)
    assert e_t != 0.0
    np.testing.assert_allclose(e_t, float(e_j), rtol=E_RTOL)
    _grad_close(g_t, g_j)


# --------------------------------------------------------------------- CMAP
def _surface_grid(r, phase=0.0):
    ang = -np.pi + 2 * np.pi * np.arange(r) / r
    return np.cos(ang + phase)[:, None] + np.sin(2 * ang)[None, :]


@pytest.mark.parametrize("r", [8, 24])
def test_cmap_coeffs_equal_jax(r):
    """build_cmap_coeffs and pack_cmap_maps (mixed resolutions) are the
    JAX package's, bit for bit."""
    g = np.random.default_rng(r).normal(0, 3, (r, r))
    np.testing.assert_array_equal(tcmap.build_cmap_coeffs(g),
                                  jcmap.build_cmap_coeffs(g))
    grids = [g, _surface_grid(12)]
    for mine, ref in zip(tcmap.pack_cmap_maps(grids),
                         jcmap.pack_cmap_maps(grids)):
        np.testing.assert_array_equal(mine, ref)


def _cmap_case(kind):
    """(pos, box, atoms8, map ids, coeffs, res): test_cmap._pentane_like on
    the analytic surface, or 24 random chains on two maps (R 24 and 12)
    whose dihedrals straddle the periodic boundary."""
    if kind == "pentane":
        pos, box, atoms8 = _pentane_like()
        coeffs, res = jcmap.pack_cmap_maps([_surface_grid(24)])
        return pos, box, atoms8, np.zeros(1, np.int32), coeffs, res
    rng = np.random.default_rng(2)
    box = np.array([2.0, 2.0, 2.0], np.float32)
    chains = []
    for _ in range(24):
        start = rng.uniform(-0.3, 0.3, 3) + np.array([0.0, 1.0, 1.0])
        steps = rng.normal(0, 1, (4, 3))
        steps *= 0.15 / np.linalg.norm(steps, axis=1, keepdims=True)
        chains.append(np.concatenate([start[None],
                                      start + np.cumsum(steps, 0)]))
    pos = (np.concatenate(chains) % box).astype(np.float32)
    atoms8 = np.array([[5 * c + k for k in (0, 1, 2, 3, 1, 2, 3, 4)]
                       for c in range(24)], np.int32)
    maps = (np.arange(24) % 2).astype(np.int32)
    coeffs, res = jcmap.pack_cmap_maps([_surface_grid(24),
                                        _surface_grid(12, 0.4)])
    return pos, box, atoms8, maps, coeffs, res


@pytest.mark.parametrize("kind", ["pentane", "chains"])
def test_cmap_energy_and_forces_match_jax(kind):
    """cmap_energy against JAX's (rtol 1e-5) and its autograd forces
    against jax.grad (atol 1e-4 max|F|); the port's dihedral angle is
    JAX's."""
    pos, box, atoms8, maps, coeffs, res = _cmap_case(kind)
    e_j, g_j = jax.value_and_grad(lambda p: jcmap.cmap_energy(
        p, jnp.asarray(box), jnp.asarray(atoms8), jnp.asarray(maps),
        jnp.asarray(coeffs), jnp.asarray(res)))(jnp.asarray(pos))
    ti = torch.int64
    e_t, g_t = _port_value_and_grad(lambda p: tcmap.cmap_energy(
        p, _t(box), _t(atoms8, ti), _t(maps, ti), _t(coeffs),
        _t(res, ti)), pos)
    np.testing.assert_allclose(e_t, float(e_j), rtol=E_RTOL, atol=1e-5)
    _grad_close(g_t, g_j)
    phi_t = tcmap.dihedral_angle(_t(pos), _t(box), _t(atoms8[:, :4], ti))
    phi_j = _dihedral_angle(jnp.asarray(pos), jnp.asarray(box),
                            jnp.asarray(atoms8[:, :4]))
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------- GB
def _port_gbdata(radii, screen, model, **kw):
    return tgb.GBData.from_numpy(_gbdata(radii, screen, model, **kw))


def _gb_both(pos, q, jd, td, chunk=1024):
    b_j = np.asarray(jgb.born_radii(jnp.asarray(pos, jnp.float32), jd,
                                    chunk))
    b_t = tgb.born_radii(_t(pos), td, chunk).numpy()
    e_j, g_j = jax.value_and_grad(lambda p: jgb.gb_energy(
        p, jnp.asarray(q, jnp.float32), jd, chunk))(
            jnp.asarray(pos, jnp.float32))
    e_t, g_t = _port_value_and_grad(
        lambda p: tgb.gb_energy(p, _t(q), td, chunk), pos)
    return (b_t, b_j), (e_t, float(e_j)), (g_t, np.asarray(g_j))


def _gb_assert(res, rtol=2e-5):
    (b_t, b_j), (e_t, e_j), (g_t, g_j) = res
    np.testing.assert_allclose(b_t, b_j, rtol=rtol)
    np.testing.assert_allclose(e_t, e_j, rtol=rtol)
    np.testing.assert_allclose(g_t, g_j, rtol=rtol,
                               atol=rtol * np.abs(g_j).max())


@pytest.mark.parametrize("model", [jgb.GB_HCT, jgb.GB_OBC1, jgb.GB_OBC2])
def test_gb_cluster_matches_jax(model):
    """born_radii, gb_energy and autograd forces on test_gb._cluster
    against JAX and jax.grad, rtol 2e-5 (tests/test_gb.py:111-114)."""
    pos, q, radii, screen = _cluster()
    _gb_assert(_gb_both(pos, q, _gbdata(radii, screen, model),
                        _port_gbdata(radii, screen, model)))


@pytest.mark.parametrize("chunk", [1024, 4])
def test_gb_salt_ace_and_chunks_match_jax(chunk):
    """OBC2 with salt, ACE and dielectrics (tests/test_gb.py:117-125), in
    one block and in (4, N) row blocks under checkpoint (9 atoms)."""
    pos, q, radii, screen = _cluster(n=9, seed=11)
    kw = dict(kappa=1.3, sasa=True, solvent_dielectric=80.0,
              solute_dielectric=2.0)
    _gb_assert(_gb_both(pos, q, _gbdata(radii, screen, jgb.GB_OBC2, **kw),
                        _port_gbdata(radii, screen, jgb.GB_OBC2, **kw),
                        chunk))


@pytest.mark.parametrize("model", [jgb.GB_HCT, jgb.GB_OBC2])
def test_build_gb_data_matches_jax(model):
    """Radii, offset and scaled radii from masses and bonds (a Drude
    particle among them) as the JAX builder makes them; GBData.from_numpy
    carries a JAX GBData across."""
    masses = [12.011, 1.008, 1.008, 1.008, 1.008, 15.999, 1.008,
              14.007, 1.008, 0.4]
    bonds = [(0, 1), (0, 2), (0, 3), (0, 4), (5, 6), (7, 8)]
    kw = dict(kappa=0.7, sasa=True, cutoff=1.5)
    jd = jgb.build_gb_data(masses, bonds, model, **kw)
    for td in (tgb.build_gb_data(masses, bonds, model, **kw),
               tgb.GBData.from_numpy(jd)):
        for k in ("radii", "or_radii", "sr_radii"):
            np.testing.assert_array_equal(getattr(td, k).numpy(),
                                          np.asarray(getattr(jd, k)))
        assert (td.model, td.kappa, td.sasa, td.cutoff) == (
            jd.model, jd.kappa, jd.sasa, jd.cutoff)


# ---------------------------------------------------- the whole evaluator
def _decorated(kind):
    """The 27-molecule drude_water box squeezed to 0.484 nm spacing (so
    NBTHOLE's 0.5 nm cutoff reaches neighbours), each Drude 0.05 nm from
    its core, carrying NBTHOLE (alternating types by molecule), CMAP (24
    cross-terms over random atoms, two maps), GB (OBC2, salt, ACE) or all
    three.  Returns (JAX system, port system, positions, box)."""
    js, pos, box = drude_water_box(27, None, jpkg.SystemBuilder)
    rng = np.random.default_rng(6)
    pos = pos * 0.88 + rng.normal(0, 0.01, pos.shape)
    box = box * 0.88
    d = rng.normal(size=(pos.shape[0] // 4, 3))
    pos[1::4] = pos[0::4] + 0.05 * d / np.linalg.norm(d, axis=1,
                                                      keepdims=True)
    pos = pos.astype(np.float32)
    n = js.n_atoms
    kw = {}
    if kind in ("nbthole", "all"):
        mol = np.arange(n) // 4
        idx = np.where(np.arange(n) % 4 < 2, 1 + mol % 2, 0)
        coef = np.zeros((3, 3))
        coef[1, 2] = coef[2, 1] = 2.6
        kw.update(nbt_idx=idx.astype(np.int32),
                  nbt_alpha=np.repeat(rng.uniform(0.8, 1.1, n // 4), 4),
                  nbt_coef=coef)
    if kind in ("cmap", "all"):
        heavy = np.where(np.arange(n) % 4 != 1)[0]
        atoms8 = np.stack([rng.choice(heavy, 8, replace=False)
                           for _ in range(24)]).astype(np.int32)
        coeffs, res = jcmap.pack_cmap_maps([_surface_grid(24),
                                            _surface_grid(12, 0.4)])
        kw.update(cmap_atoms=atoms8,
                  cmap_map=(np.arange(24) % 2).astype(np.int32),
                  cmap_coeffs=coeffs, cmap_res=res)
    if kind in ("gb", "all"):
        kw.update(gb=jgb.build_gb_data(js.masses, js.bonds, jgb.GB_OBC2,
                                       kappa=0.9, sasa=True))
    js = js.replace(**kw)
    return js, system_from_numpy(js), pos, box


@pytest.mark.parametrize("kind", ["nbthole", "cmap", "gb", "all"])
def test_force_evaluator_with_each_term_matches_jax(kind):
    """ForceEvaluator on a system carrying each term against the JAX
    ForceEvaluator, both on the dense sweep: the new terms within rtol
    1e-5, the others at the pair-sweep tolerances (rtol 5e-5, atol 0.05,
    tests/test_pallas.py:179-182), forces by assert_forces_close."""
    js, ps, pos, box = _decorated(kind)
    jf = JFE(js, pair_kernel="dense", box_hint=box, pos_hint=pos,
             recip="exact")
    tf = TFE(ps, pair_kernel="dense", box_hint=box, pos_hint=pos,
             device="cpu")
    tj, fj = jf.energy_forces(jnp.asarray(pos), jnp.asarray(box,
                                                            jnp.float32))
    tt, ft = tf.energy_forces(_t(pos), _t(box))
    assert set(tt) == set(tj)
    new = {"nbthole": ("nbthole",), "cmap": ("cmap",), "gb": ("gb",),
           "all": ("nbthole", "cmap", "gb")}[kind]
    for k in new:
        assert float(tj[k]) != 0.0, k
        np.testing.assert_allclose(float(tt[k]), float(tj[k]),
                                   rtol=E_RTOL, err_msg=k)
    for k in tj:
        np.testing.assert_allclose(float(tt[k]), float(tj[k]), rtol=5e-5,
                                   atol=0.05, err_msg=k)
    assert_forces_close(ft.numpy(), np.asarray(fj))
