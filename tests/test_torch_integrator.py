"""The integrator features of the port against the JAX package: the
partitioned Langevin thermostat (its Ornstein-Uhlenbeck map and its
extra-force form), the E-field and cosine-acceleration functions with the
velocity bias and the viscosity, 10-step Context trajectories of the middle
scheme with an E-field and cosine acceleration and of the vanilla VV scheme,
the VV force carry, a Langevin fluctuation-dissipation check, and the
Langevin x cosine conflict.

The Langevin functions take their normal draws as tensors: the test
reproduces the JAX draws from the same key (``jax.random.split`` and
``jax.random.normal``, in the JAX functions' order) and hands them to the
port, so both compute from the same numbers and agree to float32 rounding
(rtol 1e-5, atol 1e-6 nm/ps or kJ/mol/nm).  Torch's and JAX's generators
give different streams, so whole Langevin runs are held statistically."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu.forces import ForceEvaluator as JFE
from openmm_velocityverlet_tpu.integrators import stepping as jst
from openmm_velocityverlet_tpu_torch.integrators import stepping as tst
from openmm_velocityverlet_tpu_torch.models.drude_water import drude_water_box
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from openmm_velocityverlet_tpu_torch.units import BOLTZ
from tests.test_torch_slice import (  # noqa: F401 (a fixture, by name)
    _drude_positions, jax_pallas_interpret)

RTOL, ATOL = 1e-5, 1e-6


def _wire(integ, n_mol, langevin=True, efield=0.0, cos=0.0, middle=True):
    """The ``__graft_entry__._drude_system`` wiring (:58-66): Langevin on the
    last quarter of the molecules, the E-field on the cores of the others;
    cosine acceleration and the scheme on top."""
    n_ld = n_mol // 4 if langevin else 0
    for m in range(n_mol - n_ld, n_mol):
        for k in range(4):
            integ.addParticleLangevin(4 * m + k)
    if efield:
        for m in range(n_mol - n_ld):
            integ.addParticleElectrolyte(4 * m)
        integ.setElectricField(efield)
    if cos:
        integ.setCosAcceleration(cos)
    integ.setUseMiddleScheme(middle)
    return integ


def _langevin_setup(n_mol=16, seed=4, **wiring):
    js, pos, box = drude_water_box(n_mol, None, jpkg.SystemBuilder)
    ps = system_from_numpy(js)
    jdata = _wire(jpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001),
                  n_mol, **wiring).build_data(js)
    pdata = _wire(tpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001),
                  n_mol, **wiring).build_data(ps)
    assert jdata.ld_normal.shape[0] and jdata.ld_pairs.shape[0]
    np.testing.assert_array_equal(pdata.ld_normal, jdata.ld_normal)
    np.testing.assert_array_equal(pdata.ld_pairs, jdata.ld_pairs)
    rng = np.random.default_rng(seed)
    vel = rng.normal(0, 0.5, (js.n_atoms, 3)).astype(np.float32)
    return js, ps, jdata, pdata, vel


def test_langevin_ou_update_matches_jax():
    js, ps, jdata, pdata, vel = _langevin_setup()
    key = jax.random.PRNGKey(11)
    masses = np.asarray(js.masses)
    ref = np.asarray(jst.langevin_ou_update(jnp.asarray(vel), masses, key,
                                            jdata))
    n = js.n_atoms
    k1n, k1p = jax.random.split(key)
    xi_n = np.asarray(jax.random.normal(k1n, (n, 3), jnp.float32))
    xi_p = np.asarray(jax.random.normal(k1p, (n, 2, 3), jnp.float32))
    tables = tst.langevin_tables(ps, pdata, "cpu")
    got = tst.langevin_ou_update(torch.as_tensor(vel), tables,
                                 torch.tensor(xi_n),
                                 torch.tensor(xi_p)).numpy()
    # the map moved every Langevin atom and no other
    moved = np.any(ref != vel, axis=1)
    ld = np.zeros(n, bool)
    ld[np.asarray(jdata.ld_normal)] = True
    ld[np.asarray(jdata.ld_pairs).reshape(-1)] = True
    np.testing.assert_array_equal(moved, ld)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_langevin_extra_force_matches_jax():
    js, ps, jdata, pdata, vel = _langevin_setup()
    key = jax.random.PRNGKey(12)
    masses = np.asarray(js.masses)
    ref = np.asarray(jst.langevin_extra_force(jnp.asarray(vel), masses, key,
                                              jdata))
    k1, k2 = jax.random.split(key)
    xi_n = np.asarray(jax.random.normal(
        k1, (jdata.ld_normal.shape[0], 3), jnp.float32))
    xi_p = np.asarray(jax.random.normal(
        k2, (jdata.ld_pairs.shape[0], 2, 3), jnp.float32))
    tables = tst.langevin_tables(ps, pdata, "cpu")
    got = tst.langevin_extra_force(torch.as_tensor(vel), tables,
                                   torch.tensor(xi_n),
                                   torch.tensor(xi_p)).numpy()
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL * np.abs(ref).max())


def test_efield_and_cosine_functions_match_jax():
    js, ps, jdata, pdata, vel = _langevin_setup(efield=0.5)
    ref = jst.efield_extra_force(np.asarray(js.charges), jdata)
    got = tst.efield_extra_force(np.asarray(ps.charges), pdata)
    assert np.count_nonzero(ref) == 12
    np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 2.0, (js.n_atoms, 3)).astype(np.float32)
    box = np.array([2.0, 2.1, 2.2], np.float32)
    masses = np.asarray(js.masses)
    tp, tv, tb, tm = (torch.as_tensor(a) for a in (pos, vel, box, masses))
    jp, jv, jb = jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(box)
    cos_data = _wire(jpkg.VVIntegrator(), 16, langevin=False,
                     cos=0.7).build_data(js)
    np.testing.assert_allclose(
        tst.cos_extra_force(tp, tm, tb, 0.7).numpy(),
        np.asarray(jst.cos_extra_force(jp, masses, jb, cos_data)),
        rtol=RTOL, atol=ATOL)
    v_j = jst.cos_velocity_bias(jp, jv, masses, jb)
    v_t = tst.cos_velocity_bias(tp, tv, tm, tb)
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-4, atol=1e-6)
    for sign in (-1.0, 1.0):
        np.testing.assert_allclose(
            tst.cos_shift_velocity(tp, tv, tb, v_t, sign).numpy(),
            np.asarray(jst.cos_shift_velocity(jp, jv, jb, float(v_t), sign)),
            rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        float(tst.inverse_viscosity(v_t, tb, tm, 0.7)),
        float(jst.inverse_viscosity(float(v_t), jb, jnp.asarray(masses),
                                    0.7)), rtol=1e-5)


def _trajectory(pkg, js, pos, box, vel, steps, **wiring):
    """``steps`` single steps of both packages' Context on their plist
    sweeps (the JAX one on its Pallas kernel in interpret mode, as
    tests/test_torch_slice.py:111-130); returns positions per step, the
    energy terms, the kinetic energy and get_viscosity()."""
    integ = _wire(pkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001),
                  js.n_atoms // 4, langevin=False, **wiring)
    integ.setMaxDrudeDistance(0.02)
    if pkg is jpkg:
        ctx = jpkg.Context(js, integ, positions=pos, box=box, recip="exact")
        ctx.evaluator = JFE(js, pair_kernel="pallas", pallas_interpret=True,
                            box_hint=box, pos_hint=pos, recip="exact")
    else:
        ctx = tpkg.Context(system_from_numpy(js), integ, positions=pos,
                           box=box, pair_kernel="plist", device="cpu")
    ctx.set_velocities(vel)
    traj = []
    for _ in range(steps):
        ctx.step(1)
        traj.append(np.asarray(ctx.get_positions(), np.float64))
    return (np.stack(traj), ctx.potential_energy_terms(),
            ctx.kinetic_energy(), ctx.get_viscosity())


@pytest.mark.parametrize("scheme,wiring", [
    ("middle, E-field + cosine", dict(efield=5.0, cos=2.0, middle=True)),
    ("vanilla VV + cosine", dict(cos=2.0, middle=False))])
def test_context_trajectory_tracks_jax(scheme, wiring, jax_pallas_interpret):
    """10 TGNH steps of the 64-molecule drude_water (Drude pairs,
    constraints, hard wall, exact-k Ewald) with the E-field on the cores
    and cosine acceleration (fields large enough to move the trajectory in
    10 steps), in the middle and the vanilla VV scheme: max |dpos| < 2e-5
    nm per step, terms within 1e-3 relative / 0.5 kJ/mol, kinetic energy
    within 1e-3 relative, and get_viscosity() within 1e-3 relative of its
    amplitude."""
    js, pos, box = drude_water_box(64, None, jpkg.SystemBuilder)
    pos = _drude_positions(pos, seed=3)
    rng = np.random.default_rng(5)
    vel = (rng.normal(0, 1, pos.shape) * np.sqrt(
        BOLTZ * 333.0 * np.asarray(js.inv_masses))[:, None]
        ).astype(np.float32)
    tj, ej, kj, vj = _trajectory(jpkg, js, pos, box, vel, 10, **wiring)
    tt, et, kt, vt = _trajectory(tpkg, js, pos, box, vel, 10, **wiring)
    drift = np.abs(tt - tj).max(axis=(1, 2))
    print(f"\n[{scheme}] max |dpos| per step (nm): "
          + " ".join(f"{d:.2e}" for d in drift))
    print(f"[{scheme}] get_viscosity port {vt} JAX {vj}")
    assert drift.max() < 2e-5
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, atol=0.5,
                                   err_msg=k)
    np.testing.assert_allclose(kt, kj, rtol=1e-3)
    assert vj[0] != 0.0 and vj[1] != 0.0
    np.testing.assert_allclose(vt[0], vj[0], rtol=0, atol=1e-3 * abs(vj[0]))
    np.testing.assert_allclose(vt[1], vj[1], rtol=0, atol=1e-3 * abs(vj[1]))


def test_vv_force_carry():
    """The vanilla VV scheme evaluates forces once per step and once more
    after construction, ``set_positions`` or ``set_velocities``; the carry
    holds across ``step()`` calls and cache rebuilds (sort_refresh 2), and
    ``set_positions`` drops the carried extra forces too."""
    ps, pos, box = drude_water_box(27)
    integ = _wire(tpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001), 27,
                  langevin=False, efield=0.5, middle=False)
    ctx = tpkg.Context(ps, integ, positions=_drude_positions(pos), box=box,
                       device="cpu", sort_refresh=2)
    ev = ctx.evaluator
    calls = []
    real = ev.energy_forces

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    ev.energy_forces = counting
    for action, steps, expect in ((None, 3, 4), (None, 2, 2),
                                  ("vel", 1, 2), ("pos", 2, 3)):
        if action == "vel":
            ctx.set_velocities(ctx.get_velocities())
        elif action == "pos":
            assert ctx._forces_extra.abs().max() > 0
            ctx.set_positions(ctx.get_positions())
            assert not ctx._forces_extra.any()
        calls.clear()
        ctx.step(steps)
        assert len(calls) == expect, (action, steps, len(calls))
    assert ctx.rebuilds >= 4


def test_langevin_thermostat_fdt():
    """All-particle Langevin on a 64-atom argon box must equilibrate to the
    target temperature (fluctuation-dissipation of the OU map), the check
    of tests/test_physics.py:191-213 on the port with the same bound: the
    mean kinetic temperature of the last 8 of 12 blocks of 100 steps within
    15% of 150 K."""
    b = tpkg.SystemBuilder()
    n_side = 4
    for _ in range(n_side ** 3):
        b.add_particle(39.948, lj_type=0)
    b.set_lj_from_type_params([0.34], [0.996])
    box = np.array([n_side * 0.45] * 3)
    pos = np.stack(np.meshgrid(*[np.arange(n_side) * 0.45 + 0.2] * 3,
                               indexing="ij"), -1).reshape(-1, 3)
    system = b.finalize(box, r_cutoff=0.8, use_pme=False)
    integ = tpkg.VVIntegrator(temperature=150.0, step_size=0.002)
    for i in range(n_side ** 3):
        integ.addParticleLangevin(i)
    # plain cutoff Coulomb (ewald_beta 0): the plist sweep, whose Ewald
    # polynomial is identically zero there
    ctx = tpkg.Context(system, integ, positions=pos, box=box, device="cpu")
    assert ctx.evaluator.pair_mode == "plist"
    temps = []
    for _ in range(12):
        ctx.step(100)
        temps.append(2 * ctx.kinetic_energy()
                     / (3 * system.n_atoms * BOLTZ))
    mean_t = np.mean(temps[4:])
    assert abs(mean_t - 150.0) / 150.0 < 0.15, temps


def test_langevin_and_cosine_conflict_raises():
    ps, pos, box = drude_water_box(8)
    integ = tpkg.VVIntegrator()
    for i in range(4):                   # the whole first molecule
        integ.addParticleLangevin(i)
    integ.setCosAcceleration(0.1)
    with pytest.raises(ValueError, match="periodic perturbation"):
        tpkg.Context(ps, integ, positions=pos, box=box, device="cpu")
