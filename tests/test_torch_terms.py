"""Parity of the port's smaller force terms, constraints and thermostat
with the JAX package, on the same numpy inputs.  Forces are compared at the
JAX package's force-vs-gradient tolerance (tests/test_smoke.py:50-51:
rtol 2e-4, atol 2e-3); energies at rtol 2e-5 unless stated."""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu.integrators import stepping as jstep
from openmm_velocityverlet_tpu.ops import allpairs as jap
from openmm_velocityverlet_tpu.ops import constraints as jcons
from openmm_velocityverlet_tpu.ops import ewald as jew
from openmm_velocityverlet_tpu.ops import mol_terms as jmol
from openmm_velocityverlet_tpu.ops import nonbonded as jnb
from openmm_velocityverlet_tpu.ops import term_forces as jtf
from openmm_velocityverlet_tpu_torch import kernels
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


@pytest.mark.parametrize("chunked, box", [
    pytest.param(False, (2.5, 2.7, 2.6), id="False"),
    pytest.param(True, (2.5, 2.7, 2.6), id="True"),
    pytest.param(False, (2.6, 2.6, 2.6), id="False-cubic"),
    pytest.param(True, (2.6, 2.6, 2.6), id="True-cubic")])
def test_reciprocal_energy_and_forces(chunked, box):
    """The closed-form gradient against JAX's jax.grad and against float64
    autograd of the same energy (``reciprocal_energy_reference``), through
    one contraction or forced chunks; the backward scales with the incoming
    gradient, and the counters count each call and each chunked one."""
    rng = np.random.default_rng(1)
    n = 300
    box = np.array(box, np.float32)
    pos = rng.uniform(0, 2.5, (n, 3)).astype(np.float32)
    q = rng.normal(0, 0.5, n).astype(np.float32)
    q -= q.mean()
    beta, kmax = jew.ewald_parameters(0.9, 5e-4, box)
    assert (beta, kmax) == tew.ewald_parameters(0.9, 5e-4, box)
    e_j, g_j = jax.value_and_grad(lambda p: jew.reciprocal_energy(
        p, jnp.asarray(box), jnp.asarray(q), beta, kmax,
        **(dict(chunk=64, chunk_min_bytes=0.0) if chunked else {})))(
        jnp.asarray(pos))
    calls = tew.reciprocal_energy.calls
    chunks = tew.reciprocal_energy.chunked_calls
    p = _t(pos).requires_grad_(True)
    e_t = tew.reciprocal_energy(p, _t(box), _t(q), beta, kmax,
                                chunk=64 if chunked else 0)
    (g_t,) = torch.autograd.grad(e_t, p)
    np.testing.assert_allclose(float(e_t.detach()), float(e_j), rtol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=F_RTOL,
                               atol=F_ATOL)
    p64 = torch.tensor(pos, dtype=torch.float64, requires_grad=True)
    e_r = tew.reciprocal_energy_reference(
        p64, _t(box, torch.float64), _t(q, torch.float64), beta, kmax)
    (g_r,) = torch.autograd.grad(e_r, p64)
    np.testing.assert_allclose(float(e_t.detach()), float(e_r.detach()),
                               rtol=2e-6)
    np.testing.assert_allclose(g_t.numpy(), g_r.numpy(), rtol=F_RTOL,
                               atol=2e-6 * float(g_r.abs().max()))
    # the same algorithm in float64 is the autograd gradient to rounding
    p64c = p64.detach().clone().requires_grad_(True)
    e_c = tew.reciprocal_energy(p64c, _t(box, torch.float64),
                                _t(q, torch.float64), beta, kmax,
                                chunk=64 if chunked else 0)
    (g_c,) = torch.autograd.grad(e_c, p64c, grad_outputs=torch.tensor(
        -2.5, dtype=torch.float64))
    np.testing.assert_allclose(float(e_c.detach()), float(e_r.detach()),
                               rtol=1e-12)
    np.testing.assert_allclose(g_c.numpy(), -2.5 * g_r.numpy(), rtol=1e-9,
                               atol=1e-12 * float(g_r.abs().max()))
    assert tew.reciprocal_energy.calls == calls + 2
    assert tew.reciprocal_energy.chunked_calls == chunks + 2 * chunked


@pytest.mark.parametrize("n, kmax, free, chunk", [
    pytest.param(19_500, (10, 10, 10), 80e9, 0, id="water19k"),
    pytest.param(14_200, (8, 9, 31), 80e9, 0, id="slab_parents"),
    pytest.param(19_500, (10, 10, 10), 0.5e9, 14_080, id="crowded")])
def test_reciprocal_chunk_rule(n, kmax, free, chunk):
    """The matmul route's atom chunk, by shape arithmetic alone: one
    contraction while the (n, 2AB) phase block fits FREE_SHARE of the free
    bytes, else chunks whose block does; a ForceEvaluator fixes it at
    construction unless it is given one."""
    block = tew.phase_block_bytes(n, kmax)
    assert block == n * 2 * (2 * kmax[0] + 1) * (2 * kmax[1] + 1) * 4
    assert tew.chunk_rows(n, kmax, free) == chunk
    assert (chunk == 0) == (block <= tew.FREE_SHARE * free)
    if chunk:
        assert chunk % 256 == 0
        assert tew.phase_block_bytes(chunk, kmax) <= tew.FREE_SHARE * free
        assert tew.phase_block_bytes(chunk + 256, kmax) > tew.FREE_SHARE * free
    system, _, _ = _rich_system(tpkg.SystemBuilder, 2)
    ev = tpkg.ForceEvaluator(system, device="cpu")
    assert ev.ewald_chunk == tew.chunk_rows(
        system.n_atoms, system.kmax, tew.free_bytes("cpu")) == 0
    assert tpkg.ForceEvaluator(system, ewald_chunk=chunk,
                               device="cpu").ewald_chunk == chunk


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


def _interleaved_system(builder_cls, chains_at, n_water=6, n_chain=3,
                        seed=5):
    """Waters laid out O, D, H, H, M whose only term is the O-D Drude spring
    (a one-molecule run each, between term-less atoms) and a block of
    four-atom chains back to back (one long run), the block placed
    ``chains_at`` the first, between or after the waters."""
    b = builder_cls()
    rng = np.random.default_rng(seed)
    box = np.array([3.0, 3.1, 2.9])
    pos = []

    def water():
        o, d, h1, h2, m = (b.add_particle(mass, charge=q, lj_type=1)
                           for mass, q in ((15.2, 1.2), (0.4, -1.0),
                                           (1.0, 0.5), (1.0, 0.5),
                                           (0.0, -1.2)))
        c = rng.uniform(0.3, 2.6, 3)
        pos.extend([c, c + rng.normal(0, 0.01, 3), c + [0.09, 0, 0],
                    c + [0, 0.09, 0], c + [0.01, 0.01, 0]])
        b.add_drude(d, o, -1, -1, -1, -1.0, 0.00097, 1.0, 1.0)

    def chain():
        a = [b.add_particle(12.0, charge=0.1, lj_type=0) for _ in range(4)]
        d = b.add_particle(0.4, charge=-0.5, lj_type=1)
        c = rng.uniform(0.3, 2.4, 3)
        pts = c + np.array([[0, 0, 0], [0.15, 0, 0], [0.2, 0.14, 0],
                            [0.35, 0.15, 0.08]]) + rng.normal(0, 0.01, (4, 3))
        pos.extend(list(pts) + [pts[1] + rng.normal(0, 0.008, 3)])
        b.add_bond(a[0], a[1], 0.15, 2e5)
        b.add_bond(a[1], a[2], 0.15, 2e5)
        b.add_bond(a[2], a[3], 0.15, 2e5)
        b.add_angle(a[0], a[1], a[2], 1.9, 400.0)
        b.add_urey_bradley(a[0], a[2], 0.25, 3e4)
        b.add_dihedral(a[0], a[1], a[2], a[3], 3, 0.3, 2.5)
        b.add_improper(a[1], a[0], a[2], a[3], 5.0)
        b.add_drude(d, a[1], a[0], a[2], a[3], -0.5, 0.0012, 1.1, 0.9)

    split = {"first": 0, "between": n_water // 2, "last": n_water}[chains_at]
    for _ in range(split):
        water()
    for _ in range(n_chain):
        chain()
    for _ in range(split, n_water):
        water()
    b.set_lj_from_type_params([0.32, 0.1], [0.5, 0.0])
    return (b.finalize(box, r_cutoff=1.0, use_pme=True),
            np.array(pos, np.float32), box.astype(np.float32))


@pytest.mark.parametrize("chains_at", ["first", "between", "last"])
def test_mol_terms_interleaved_match_jax(chains_at):
    js, pos, box = _interleaved_system(jpkg.SystemBuilder, chains_at)
    ps, pos2, _ = _interleaved_system(tpkg.SystemBuilder, chains_at)
    np.testing.assert_array_equal(pos, pos2)
    jt, jleft = jmol.build_mol_tables(js)
    pt, pleft = tmol.build_mol_tables(ps)
    assert sorted((t.apm, len(t.runs), t.n_mol) for t in pt) == [(2, 6, 6),
                                                                 (5, 1, 3)]
    assert not any(np.any(v) for v in pleft.values())
    e_j, f_j = jax.jit(lambda p, bx: jmol.energies_and_forces(
        p, bx, jt, js.n_atoms))(jnp.asarray(pos), jnp.asarray(box))
    tt = tmol.types_to(pt, "cpu")
    e_t, f_t = tmol.energies_and_forces(_t(pos), _t(box), tt, ps.n_atoms)
    _cmp_energies(e_t, e_j)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=F_RTOL,
                               atol=F_ATOL)
    # every term on the sparse path: independent code, same forces
    pterms, pinc, _ = ttf.build_term_tables(ps)
    _, f_s = ttf.energies_and_forces(_t(pos), _t(box),
                                     *ttf.tables_to(pterms, pinc, "cpu"))
    np.testing.assert_allclose(f_t.numpy(), f_s.numpy(), rtol=F_RTOL,
                               atol=F_ATOL)
    term_less = np.ones(ps.n_atoms, bool)
    for t in tt:
        term_less[t.idx.numpy()] = False
    assert term_less.sum() == 6 * 3       # each water's H, H and M
    assert not f_t.numpy()[term_less].any()


_VIEW_OPS = {"aten::view", "aten::reshape", "aten::_reshape_alias",
             "aten::_unsafe_view", "aten::slice", "aten::select",
             "aten::narrow", "aten::permute", "aten::t", "aten::transpose",
             "aten::expand", "aten::as_strided", "aten::unsqueeze",
             "aten::squeeze", "aten::alias", "aten::detach"}


def test_mol_terms_ops_per_call_independent_of_runs():
    """A call launches the same ops for 4 one-molecule runs as for 400."""
    from torch.profiler import ProfilerActivity, profile

    def ops(n_water):
        ps, pos, box = _interleaved_system(tpkg.SystemBuilder, "last",
                                           n_water=n_water, n_chain=0)
        pt, _ = tmol.build_mol_tables(ps)
        assert [(t.apm, len(t.runs)) for t in pt] == [(2, n_water)]
        tt, p, bx = tmol.types_to(pt, "cpu"), _t(pos), _t(box)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tmol.energies_and_forces(p, bx, tt, ps.n_atoms)
        names = [ev.name for ev in prof.events()
                 if ev.name.startswith("aten::")]
        return sorted(n for n in names if n not in _VIEW_OPS)

    few, many = ops(4), ops(400)
    assert few and few == many


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


@pytest.mark.parametrize("velocities", [False, True])
def test_constraint_clusters_on_cpu_take_the_plain_version(velocities):
    """Five buckets (K = 1 to 4, the CH3 and CH4 stars among them), a share
    of the clusters straddling the box faces: a CPU call through the entry
    point runs the plain version, bitwise, launches no kernel and loads no
    kernel library; it agrees with the JAX package as the test above."""
    pairs, dists, inv_m, pos, new, vel, box = chip_smoke.cluster_system(
        5, {"swm4": 60, "ch3": 20, "k1": 10, "k2": 10, "ch4": 10})
    tc = tcons.build_constraint_data(pairs, dists, inv_m, device="cpu")
    jc = jcons.build_constraint_data(pairs, dists, inv_m)
    assert sorted((bk["K"], bk["A"]) for bk in tc.buckets) == [
        (1, 2), (2, 3), (3, 3), (3, 4), (4, 5)]
    cc = tcons.constraint_clusters
    before = (cc.launches, cc.shake_launches, cc.rattle_launches)
    target = vel if velocities else new
    if velocities:
        out = tcons.apply_velocity_constraints(_t(pos), _t(vel), _t(box), tc,
                                               _t(inv_m))
        plain = tcons.solve_velocity_clusters(_t(pos), _t(vel), _t(box), tc)
        jout = jcons.apply_velocity_constraints(
            jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(box), jc,
            jnp.asarray(inv_m))
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        out = tcons.apply_position_constraints(_t(pos), _t(new), _t(box), tc,
                                               _t(inv_m))
        plain = tcons.solve_position_clusters(_t(pos), _t(new), _t(box), tc)
        jout = jcons.apply_position_constraints(
            jnp.asarray(pos), jnp.asarray(new), jnp.asarray(box), jc,
            jnp.asarray(inv_m))
        tol = dict(rtol=0, atol=2e-6)
    assert torch.equal(out, plain)
    assert (cc.launches, cc.shake_launches, cc.rattle_launches) == before
    assert "constraint_clusters" not in kernels._loaded
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)
    free = ~tc.atom_in_cluster.numpy()
    assert free.any()
    np.testing.assert_array_equal(out.numpy()[free], target[free])
    rel_pos, rel_vel = chip_smoke.constraint_residuals(
        pos if velocities else out.numpy(), out.numpy() if velocities
        else None, pairs, dists, box)
    if velocities:
        assert rel_vel < 1e-4
    else:
        assert rel_pos < 2e-5


def test_constraints_import_without_nvcc():
    """The constraints module, and the package, import where no nvcc can be
    found: the kernel library is built only at a CUDA call."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    code = ("import shutil, sys; "
            "from openmm_velocityverlet_tpu_torch.ops import constraints; "
            "from openmm_velocityverlet_tpu_torch import kernels; "
            "cc = constraints.constraint_clusters; "
            "assert cc.launches == cc.shake_launches == 0; "
            "assert cc.rattle_launches == 0; "
            "assert 'constraint_clusters' in kernels.SOURCES; "
            "assert not kernels._loaded; "
            "print(shutil.which('nvcc'))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"


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
