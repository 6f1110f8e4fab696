"""Parity of the port's smaller force terms, constraints and thermostat
with the JAX package, on the same numpy inputs.  Forces are compared at the
JAX package's force-vs-gradient tolerance (tests/test_smoke.py:50-51:
rtol 2e-4, atol 2e-3); energies at rtol 2e-5 unless stated."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu.integrators import stepping as jstep
from openmm_velocityverlet_tpu.ops import allpairs as jap
from openmm_velocityverlet_tpu.ops import constraints as jcons
from openmm_velocityverlet_tpu.ops import ewald as jew
from openmm_velocityverlet_tpu.ops import mol_terms as jmol
from openmm_velocityverlet_tpu.ops import nonbonded as jnb
from openmm_velocityverlet_tpu.ops import term_forces as jtf
from openmm_velocityverlet_tpu_torch.integrators import stepping as tstep
from openmm_velocityverlet_tpu_torch.models.drude_water import drude_water_box
from openmm_velocityverlet_tpu_torch.ops import constraints as tcons
from openmm_velocityverlet_tpu_torch.ops import ewald as tew
from openmm_velocityverlet_tpu_torch.ops import mol_terms as tmol
from openmm_velocityverlet_tpu_torch.ops import nonbonded as tnb
from openmm_velocityverlet_tpu_torch.ops import term_forces as ttf
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from tests.test_flexible_skip import make_constrained_fluid

F_RTOL, F_ATOL = 2e-4, 2e-3


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _rich_system(builder_cls, n_mol=6, seed=2):
    """Four-atom chains with two Drude particles each: every bonded kind
    (bond, angle, Urey-Bradley, dihedral, improper), an anisotropic and an
    isotropic Drude spring, a Thole pair, a 1-4 exception and TT donors."""
    b = builder_cls()
    rng = np.random.default_rng(seed)
    pos = []
    donors = []
    for m in range(n_mol):
        a = [b.add_particle(12.0, charge=0.3 - 0.2 * k, lj_type=k % 2)
             for k in range(4)]
        d1 = b.add_particle(0.4, charge=-0.6, lj_type=1)
        d2 = b.add_particle(0.4, charge=-0.5, lj_type=1)
        base = np.array([(m % 3) * 0.55 + 0.3, (m // 3) * 0.6 + 0.3, 1.0])
        chain = base + np.array([[0, 0, 0], [0.15, 0, 0], [0.2, 0.14, 0],
                                 [0.35, 0.15, 0.08]])
        chain += rng.normal(0, 0.01, chain.shape)
        pos += list(chain)
        pos += [chain[1] + rng.normal(0, 0.008, 3),
                chain[2] + rng.normal(0, 0.008, 3)]
        b.add_bond(a[0], a[1], 0.15, 2e5)
        b.add_bond(a[1], a[2], 0.15, 2e5)
        b.add_bond(a[2], a[3], 0.15, 2e5)
        b.add_angle(a[0], a[1], a[2], 1.9, 400.0)
        b.add_angle(a[1], a[2], a[3], 2.0, 350.0)
        b.add_urey_bradley(a[0], a[2], 0.25, 3e4)
        b.add_dihedral(a[0], a[1], a[2], a[3], 3, 0.3, 2.5)
        b.add_improper(a[1], a[0], a[2], a[3], 5.0)
        b.add_drude(d1, a[1], a[0], a[2], a[3], -0.6, 0.0012, 1.1, 0.9)
        b.add_drude(d2, a[2], -1, -1, -1, -0.5, 0.0009, 1.0, 1.0)
        b.add_thole_pair(d1, a[1], d2, a[2], -0.6, -0.5, 2.6, 0.0012, 0.0009)
        b.add_exception(a[0], a[3], 0.5 * 0.3 * -0.3, 0.3, 0.4)
        atoms = a + [d1, d2]
        for i in atoms:
            for j in atoms:
                if i < j:
                    b.add_exclusion(i, j)
        donors.append(a[3])
    b.set_lj_from_type_params([0.32, 0.1], [0.5, 0.0])
    n = 6 * n_mol
    tt_q = np.zeros(n)
    tt_q[np.arange(n) % 6 == 1] = 0.6
    tt_q[np.arange(n) % 6 == 3] = -0.4
    b.set_tt_damping(donors, tt_q, b=12.0, cutoff=1.0)
    box = np.array([3.2, 3.4, 3.0])
    return b.finalize(box, r_cutoff=1.0, use_pme=True), np.array(pos), box


@pytest.mark.parametrize("chunked", [False, True])
def test_reciprocal_energy_and_forces(chunked):
    rng = np.random.default_rng(1)
    n = 300
    box = np.array([2.5, 2.7, 2.6], np.float32)
    pos = rng.uniform(0, 2.5, (n, 3)).astype(np.float32)
    q = rng.normal(0, 0.5, n).astype(np.float32)
    q -= q.mean()
    beta, kmax = jew.ewald_parameters(0.9, 5e-4, box)
    assert (beta, kmax) == tew.ewald_parameters(0.9, 5e-4, box)
    kw = dict(chunk=64, chunk_min_bytes=0.0) if chunked else {}
    e_j, g_j = jax.value_and_grad(lambda p: jew.reciprocal_energy(
        p, jnp.asarray(box), jnp.asarray(q), beta, kmax, **kw))(
        jnp.asarray(pos))
    p = _t(pos).requires_grad_(True)
    e_t = tew.reciprocal_energy(p, _t(box), _t(q), beta, kmax, **kw)
    (g_t,) = torch.autograd.grad(e_t, p)
    np.testing.assert_allclose(float(e_t.detach()), float(e_j), rtol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=F_RTOL,
                               atol=F_ATOL)


def _both(n_mol=6):
    js, pos, box = _rich_system(jpkg.SystemBuilder, n_mol)
    ps, pos2, _ = _rich_system(tpkg.SystemBuilder, n_mol)
    np.testing.assert_array_equal(pos, pos2)
    return js, ps, pos.astype(np.float32), box.astype(np.float32)


def _cmp_energies(mine, ref, rtol=2e-5, atol=1e-4):
    assert set(mine) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(mine[k]), float(ref[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_term_forces_match_jax():
    js, ps, pos, box = _both()
    terms, inc, total = jtf.build_term_tables(js)
    e_j, f_j = jax.jit(lambda p, bx: jtf.energies_and_forces(
        p, bx, terms, inc, total))(jnp.asarray(pos), jnp.asarray(box))
    pterms, pinc, ptotal = ttf.build_term_tables(ps)
    assert ptotal == total and len(pterms) == len(terms) == 6
    e_t, f_t = ttf.energies_and_forces(_t(pos), _t(box),
                                       *ttf.tables_to(pterms, pinc, "cpu"))
    _cmp_energies(e_t, e_j)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=F_RTOL,
                               atol=F_ATOL)


def test_mol_terms_match_jax():
    js, ps, pos, box = _both()
    tables = jap.build_pair_tables(js.n_atoms, js.lj_type, js.acoef,
                                   js.bcoef, js.exclusions, exc_idx=js.exc_idx,
                                   exc_qq=js.exc_qq, exc_c6=js.exc_c6,
                                   exc_c12=js.exc_c12, charges=js.charges,
                                   fold_exc14=False)
    jt, jleft = jmol.build_mol_tables(js, exc_mask=tables["exc_term_mask"])
    pt, pleft = tmol.build_mol_tables(ps, exc_mask=tables["exc_term_mask"])
    assert len(pt) == len(jt) == 1
    for k in jleft:
        np.testing.assert_array_equal(pleft[k], jleft[k])
    e_j, f_j = jax.jit(lambda p, bx: jmol.energies_and_forces(
        p, bx, jt, js.n_atoms))(jnp.asarray(pos), jnp.asarray(box))
    e_t, f_t = tmol.energies_and_forces(_t(pos), _t(box),
                                        tmol.types_to(pt, "cpu"), ps.n_atoms)
    _cmp_energies(e_t, e_j)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=F_RTOL,
                               atol=F_ATOL)


def test_nonbonded_small_terms_match_jax():
    js, ps, pos, box = _both()
    q = np.asarray(js.charges)
    np.testing.assert_allclose(
        float(tnb.ewald_self_energy(_t(q), js.ewald_beta, _t(box))),
        float(jnb.ewald_self_energy(jnp.asarray(q), js.ewald_beta,
                                    jnp.asarray(box))), rtol=2e-6)
    for rs in (0.0, 0.8):
        np.testing.assert_allclose(
            float(tnb.dispersion_correction(_t(box), ps.disp_coef_a2,
                                            ps.disp_coef_b, 1.0, rs)),
            float(jnb.dispersion_correction(jnp.asarray(box), js.disp_coef_a2,
                                            js.disp_coef_b, 1.0, rs)),
            rtol=2e-6)
    t = ps.to("cpu")

    def jtt(p):
        return jnb.tt_damping_energy(p, jnp.asarray(box), js.tt_donors,
                                     js.tt_charges, js.tt_dipole_mask,
                                     js.exclusions, js.tt_b, js.tt_cutoff)
    e_j, g_j = jax.jit(jax.value_and_grad(jtt))(jnp.asarray(pos))
    p = _t(pos).requires_grad_(True)
    e_t = tnb.tt_damping_energy(p, _t(box), t.tt_donors, t.tt_charges,
                                t.tt_dipole_mask, t.exclusions,
                                float(ps.tt_b), float(ps.tt_cutoff))
    (g_t,) = torch.autograd.grad(e_t, p)
    assert abs(float(e_j)) > 1e-3
    np.testing.assert_allclose(float(e_t.detach()), float(e_j), rtol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=F_RTOL,
                               atol=F_ATOL)


def _chain_system(builder_cls):
    """A 7-atom chain of 6 constraints: one cluster larger than K_CAP, so
    the iterative pair solvers run."""
    b = builder_cls()
    for k in range(7):
        b.add_particle(12.0 + k, lj_type=0)
    for k in range(6):
        b.add_constraint(k, k + 1, 0.15)
        b.add_exclusion(k, k + 1)
    b.set_lj_from_type_params([0.3], [0.4])
    box = np.array([3.0] * 3)
    pos = np.array([[0.5 + 0.15 * k, 1.0 + 0.02 * (k % 2), 1.0]
                    for k in range(7)])
    return b.finalize(box, r_cutoff=1.0, use_pme=False), pos, box


@pytest.mark.parametrize("kind", ["clusters", "iterative"])
def test_shake_rattle_match_jax(kind):
    if kind == "clusters":
        js, pos, box = make_constrained_fluid()
    else:
        js, pos, box = _chain_system(jpkg.SystemBuilder)
    ps = system_from_numpy(js)
    args = (np.asarray(js.constraints), np.asarray(js.constraint_dist),
            np.asarray(js.inv_masses))
    jc = jcons.build_constraint_data(*args)
    tc = tcons.build_constraint_data(*args, device="cpu")
    assert jc.use_clusters == tc.use_clusters == (kind == "clusters")
    rng = np.random.default_rng(9)
    pos = pos.astype(np.float32)
    new = (pos + rng.normal(0, 0.004, pos.shape)).astype(np.float32)
    vel = rng.normal(0, 0.5, pos.shape).astype(np.float32)
    inv_m = np.asarray(js.inv_masses, np.float32)
    jb = jnp.asarray(box, jnp.float32)
    p_j = jcons.apply_position_constraints(jnp.asarray(pos), jnp.asarray(new),
                                           jb, jc, jnp.asarray(inv_m))
    p_t = tcons.apply_position_constraints(_t(pos), _t(new), _t(box), tc,
                                           _t(inv_m))
    v_j = jcons.apply_velocity_constraints(jnp.asarray(pos), jnp.asarray(vel),
                                           jb, jc, jnp.asarray(inv_m))
    v_t = tcons.apply_velocity_constraints(_t(pos), _t(vel), _t(box), tc,
                                           _t(inv_m))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5,
                               atol=1e-5)
    # residuals: constrained distances restored, relative velocities gone
    c = np.asarray(ps.constraints)
    d = np.asarray(ps.constraint_dist)
    dr = p_t.numpy()[c[:, 0]] - p_t.numpy()[c[:, 1]]
    tol = 2e-5 if kind == "clusters" else 1e-4
    assert np.max(np.abs(np.linalg.norm(dr, axis=1) - d) / d) < tol
    ref = pos[c[:, 0]] - pos[c[:, 1]]
    rv = np.sum((v_t.numpy()[c[:, 0]] - v_t.numpy()[c[:, 1]]) * ref, -1)
    assert np.max(np.abs(rv)) < 1e-4


@pytest.mark.parametrize("use_com", [True, False])
def test_nh_scale_velocities_match_jax(use_com):
    js, pos, box = drude_water_box(27, None, jpkg.SystemBuilder)
    ps = system_from_numpy(js)
    ji = jpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
    ti = tpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
    if not use_com:
        ji.setUseCOMTempGroup(False)
        ti.setUseCOMTempGroup(False)
    jd, td = ji.build_data(js), ti.build_data(ps)
    np.testing.assert_array_equal(td.eta_mass, jd.eta_mass)
    np.testing.assert_array_equal(td.temp_group_dof, jd.temp_group_dof)
    rng = np.random.default_rng(4)
    vel = (rng.normal(0, 0.6, (js.n_atoms, 3))
           * (np.asarray(js.masses) > 0)[:, None]).astype(np.float32)
    eta = rng.normal(0, 0.1, (3, 3)).astype(np.float32)
    eta_dot = rng.normal(0, 0.5, (3, 4)).astype(np.float32)
    eta_dd = rng.normal(0, 0.5, (3, 3)).astype(np.float32)
    runs = jstep.mol_runs_from_id(js.particle_mol_id)
    out_j = jstep.nh_scale_velocities(
        jnp.asarray(vel), np.asarray(js.masses), np.asarray(js.inv_masses),
        js.particle_mol_id, js.mol_masses, js.mol_inv_masses, jd,
        jnp.asarray(eta), jnp.asarray(eta_dot), jnp.asarray(eta_dd),
        mol_table=js.mol_table, mol_runs=runs)
    tables = tstep.thermostat_tables(ps, td, "cpu")
    out_t = tstep.nh_scale_velocities(_t(vel), td, tables, _t(eta),
                                      _t(eta_dot), _t(eta_dd))
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    if not use_com:
        return
    # the member-table COM path (molecules not contiguous) equals the runs
    table = np.asarray(ps.mol_table)
    idx = np.maximum(table, 0)
    gather = dict(mol_runs=None, mol_idx=torch.as_tensor(idx),
                  mol_w=_t(np.asarray(ps.masses)[idx] * (table >= 0)),
                  mol_inv_masses=_t(ps.mol_inv_masses))
    np.testing.assert_allclose(
        tstep.com_velocities(_t(vel), gather).numpy(),
        tstep.com_velocities(_t(vel), tables).numpy(), rtol=1e-5, atol=1e-6)


def test_hardwall_image_sync_and_compensated_add_match_jax():
    js, pos, box = drude_water_box(27, None, jpkg.SystemBuilder)
    ps = system_from_numpy(js)
    ji = jpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
    ji.setMaxDrudeDistance(0.02)
    ti = tpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
    ti.setMaxDrudeDistance(0.02)
    jd, td = ji.build_data(js), ti.build_data(ps)
    rng = np.random.default_rng(6)
    p = (pos + rng.normal(0, 0.02, pos.shape)).astype(np.float32)
    v = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    pj, vj = jstep.apply_hardwall(jnp.asarray(p), jnp.asarray(v),
                                  np.asarray(js.masses),
                                  np.asarray(js.inv_masses),
                                  jnp.asarray(box), jd)
    pt, vt = tstep.apply_hardwall(_t(p), _t(v),
                                  tstep.hardwall_tables(ps, td, "cpu"))
    assert not np.array_equal(np.asarray(pj), p)    # some pairs bounced
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)
    # the image sync: images copy x, y of their parent and mirror z
    pairs = np.array([[5, 0], [9, 4], [30, 2]], np.int32)
    img = SimpleNamespace(image_pairs=pairs, mirror_location=0.7)
    np.testing.assert_array_equal(
        tstep.update_image_positions(
            _t(p), torch.as_tensor(pairs.astype(np.int64)), 0.7).numpy(),
        np.asarray(jstep.update_image_positions(jnp.asarray(p), img)))
    d = rng.normal(0, 1e-4, p.shape).astype(np.float32)
    e = rng.normal(0, 1e-8, p.shape).astype(np.float32)
    for a, b in zip(tstep.compensated_add(_t(p), _t(e), _t(d)),
                    jstep.compensated_add(jnp.asarray(p), jnp.asarray(e),
                                          jnp.asarray(d))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
