"""The Monte Carlo barostat of the port against the JAX package: the axis
weights of the five kinds, single attempts with the JAX draws handed to the
port (the same accept flags, positions and box to 1e-6 relative, and the
same move-size adaptation over 12 attempts), and a Context run on the
argon-like LJ fluid of tests/test_smoke.make_lj_fluid with an attempt every
5 steps (the same accept / reject sequence as the JAX Context); and the
repeat on the full pair list of an energy query or an attempt whose list
comes back flagged.

The JAX barostat draws from its own threefry key, the port from the
State's torch.Generator; the tests rebuild the JAX draws from its key (in
the JAX ``attempt_move`` order) and pass them to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu.forces import ForceEvaluator as JFE
from openmm_velocityverlet_tpu.integrators import barostat as jbaro
from openmm_velocityverlet_tpu_torch.integrators import barostat as tbaro
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from tests.test_smoke import make_lj_fluid

KINDS = ("iso", "xyz", "xy", "z", "semi-iso")


def jax_draws(kind, key):
    """(draws for the port, the key after the attempt) from a JAX barostat
    key: the splits of the JAX ``_axis_weights`` and ``attempt_move``."""
    out = {}
    if kind in ("xyz", "xy"):
        key, k = jax.random.split(key)
        out["axis"] = int(jax.random.randint(k, (), 0,
                                             3 if kind == "xyz" else 2))
    elif kind == "semi-iso":
        key, k = jax.random.split(key)
        out["pick_z"] = bool(jax.random.bernoulli(k))
    key, k_dv, k_acc = jax.random.split(key, 3)
    out["u_dv"] = float(jax.random.uniform(k_dv))
    out["u_acc"] = float(jax.random.uniform(k_acc))
    return out, key


@pytest.mark.parametrize("kind", KINDS)
def test_axis_weights_match_jax(kind):
    key = jax.random.PRNGKey(3)
    seen = set()
    for _ in range(12):
        w_j, _ = jbaro._axis_weights(kind, key)
        draws, key = jax_draws(kind, key)
        w_t = tbaro._axis_weights(kind, draws, "cpu")
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
        seen.add(tuple(w_t.tolist()))
    # the random kinds pick more than one set of axes in 12 attempts
    assert len(seen) == (1 if kind in ("iso", "z") else 2 if kind in (
        "xy", "semi-iso") else 3)


def _fluid():
    js, pos, box = make_lj_fluid(n_side=4, spacing=0.42)
    ps = system_from_numpy(js)
    rng = np.random.default_rng(2)
    pos = (pos + rng.normal(0, 0.02, pos.shape)).astype(np.float32)
    return js, ps, pos, np.asarray(box, np.float32)


@pytest.mark.parametrize("kind,temperature", [
    ("iso", 120.0), ("xyz", 120.0), ("xy", 120.0), ("z", 120.0),
    ("semi-iso", 120.0), ("iso", 5000.0)])
def test_attempt_move_matches_jax(kind, temperature):
    """12 attempts on the LJ fluid at 200 bar, each side moving on from its
    own result; at 5000 K nearly every move is taken, so the 10th attempt
    grows the move size."""
    js, ps, pos, box = _fluid()
    jev = JFE(js)
    efn_j = jax.jit(lambda p, b: sum(jev.energy_forces(p, b)[0].values()))
    tev = tpkg.ForceEvaluator(ps, box_hint=box, pos_hint=pos, device="cpu")

    def efn_t(p, b):
        return sum(tev.energy_forces(p, b)[0].values())
    cfg_j = jpkg.BarostatConfig(kind, 200.0, temperature, 10)
    cfg_t = tpkg.BarostatConfig(kind, 200.0, temperature, 10)
    vol = float(np.prod(box.astype(np.float64)))
    bs_j = jbaro.make_barostat_state(vol)
    bs_t = tbaro.make_barostat_state(vol, device="cpu")
    mol = tbaro.molecule_tables(ps, "cpu")
    pj, bj = jnp.asarray(pos), jnp.asarray(box)
    pt, bt = torch.tensor(pos), torch.tensor(box)
    accepts, scales = [], []
    for _ in range(12):
        draws, _ = jax_draws(kind, bs_j.key)
        acc_j, pj, bj, bs_j = jbaro.attempt_move(
            cfg_j, bs_j, pj, bj, js.particle_mol_id, js.mol_masses,
            js.mol_inv_masses, js.masses, efn_j, mol_table=js.mol_table)
        acc_t, pt, bt, bs_t, _ = tbaro.attempt_move(
            cfg_t, bs_t, pt, bt, mol, efn_t, draws)
        assert bool(acc_t) == bool(acc_j)
        accepts.append(bool(acc_t))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6)
        np.testing.assert_allclose(float(bs_t.volume_scale),
                                   float(bs_j.volume_scale), rtol=1e-6)
        assert int(bs_t.n_attempted) == int(bs_j.n_attempted)
        assert int(bs_t.n_accepted) == int(bs_j.n_accepted)
        scales.append(float(bs_t.volume_scale))
    print(f"\n[{kind}, {temperature} K] accepts {accepts}; move size "
          f"{scales[0]:.5f} -> {scales[-1]:.5f} nm^3")
    assert any(accepts)
    if temperature > 1000:
        assert scales[-1] == pytest.approx(scales[0] * 1.1, rel=1e-6)


def _npt_run(pkg, steps, freq):
    """``steps`` single steps of the LJ fluid at 200 bar and 120 K with an
    attempt every ``freq`` steps; returns the accept flag of each attempt,
    the positions and the box."""
    js, _, pos, box = _fluid()
    integ = pkg.VVIntegrator(120.0, 10.0, 1.0, 40.0, 0.002)
    cfg = pkg.BarostatConfig("iso", 200.0, 120.0, freq)
    rng = np.random.default_rng(4)
    vel = (rng.normal(0, 1, pos.shape) * np.sqrt(
        0.0083144626 * 120.0 / 39.948)).astype(np.float32)
    if pkg is jpkg:
        ctx = jpkg.Context(js, integ, positions=pos, box=box, barostat=cfg)
    else:
        ctx = tpkg.Context(system_from_numpy(js), integ, positions=pos,
                           box=box, barostat=cfg, device="cpu")
        key = [jax.random.PRNGKey(7)]        # make_barostat_state's seed

        def draws():
            d, key[0] = jax_draws("iso", key[0])
            return d
        ctx._barostat_draws = draws
    ctx.set_velocities(vel)
    accepts, seen = [], 0
    for i in range(steps):
        ctx.step(1)
        if i % freq:
            continue
        if pkg is jpkg:
            n_acc = int(ctx._carry.baro.n_accepted)
            accepts.append(n_acc > seen)
            seen = n_acc
        else:
            accepts.append(ctx.baro_accepts > seen)
            seen = ctx.baro_accepts
    return accepts, ctx.get_positions(), ctx.get_box(), ctx


def test_context_barostat_tracks_jax():
    """40 steps, an attempt every 5 (8 attempts, before the JAX counts
    reset at 10): the same accept / reject sequence, then positions within
    1e-4 nm and the box within 1e-6 relative; every accepted move leaves
    finite energies."""
    acc_j, pos_j, box_j, _ = _npt_run(jpkg, 40, 5)
    acc_t, pos_t, box_t, ctx = _npt_run(tpkg, 40, 5)
    print(f"\naccepts JAX {acc_j} port {acc_t}; box {box_t}")
    assert acc_t == acc_j
    assert any(acc_t) and not all(acc_t)
    assert ctx.baro_attempts == 8 and ctx.baro_accepts == sum(acc_t)
    np.testing.assert_allclose(box_t, box_j, rtol=1e-6)
    assert np.abs(pos_t - pos_j).max() < 1e-4
    assert all(np.isfinite(v) for v in ctx.potential_energy_terms().values())


def test_flagged_energy_list_repeats_on_the_full_list():
    """An energy query (terms or forces) or a barostat attempt whose pair
    list comes back flagged (here: a capacity of 2 tile pairs) is repeated
    on the full list and gives what an unflagged list gives; the attempt
    reads its flags with its accept flag, one host read a try."""
    from openmm_velocityverlet_tpu_torch.models.drude_water import \
        drude_water_box
    ps, pos, box = drude_water_box(64)
    out = []
    for cap in (None, 2):
        ctx = tpkg.Context(ps, tpkg.VVIntegrator(), positions=pos, box=box,
                           device="cpu", barostat=tpkg.BarostatConfig(
                               "iso", 1.0, 333.0, 5))
        ev, st = ctx.evaluator, ctx.state
        if cap is not None:
            ev.pairs.cap_all = cap
        flagged = bool(ev.energy_forces(st.pos, st.box, return_cov=True)[2])
        assert flagged == (cap is not None)
        terms = ctx.potential_energy_terms()
        forces = ctx.get_forces()
        ctx._barostat_draws = lambda: {"u_dv": 0.1, "u_acc": 0.5}
        syncs = ctx.host_syncs
        acc = ctx._barostat_attempt()
        assert ctx.host_syncs - syncs == (2 if flagged else 1)
        out.append((terms, forces, acc, ctx.get_box()))
    (t0, f0, a0, b0), (t1, f1, a1, b1) = out
    for k in t0:
        np.testing.assert_allclose(t1[k], t0[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(f1, f0, rtol=1e-5, atol=1e-4)
    assert a1 == a0
    np.testing.assert_array_equal(b1, b0)
