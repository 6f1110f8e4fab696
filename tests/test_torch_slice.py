"""The slice as a whole against the JAX package: the full ForceEvaluator
(terms dict + forces) and a 10-step middle-scheme TGNH trajectory of the
Context, from the same numpy positions and velocities."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu.forces import ForceEvaluator as JFE
from openmm_velocityverlet_tpu.ops import pallas_pair as jpp
from openmm_velocityverlet_tpu_torch.forces import (PLIST_TILE_SIZES,
                                                    ForceEvaluator as TFE)
from openmm_velocityverlet_tpu_torch.models.drude_water import drude_water_box
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from tests.test_smoke import make_lj_fluid

# the JAX package's pair-sweep tolerances (tests/test_pallas.py:179-182)
E_RTOL, E_ATOL = 5e-5, 0.05
F_RTOL, F_ATOL = 1e-3, 5e-2


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX ForceEvaluator does not forward ``pallas_interpret`` to
    ``direct_space_pallas`` on its single-device path (forces.py:465), so
    on the CPU its Pallas plist kernel refuses to lower; run it in
    interpret mode, as tests/test_pallas.py does, without editing the JAX
    package."""
    monkeypatch.setattr(jpp, "direct_space_pallas", functools.partial(
        jpp.direct_space_pallas, interpret=True))


def _drude_positions(pos, seed=1):
    """Thermal-like jitter, with every Drude particle 0.012 nm from its
    core: the excluded-pair correction -qq erf(beta r)/r cancels
    catastrophically in float32 as r -> 0 in the energy form (the A&S erfc
    path), so near-coincident pairs would compare rounding noise."""
    rng = np.random.default_rng(seed)
    p = pos + rng.normal(0, 0.01, pos.shape)
    d = rng.normal(size=(pos.shape[0] // 4, 3))
    d *= 0.012 / np.linalg.norm(d, axis=1, keepdims=True)
    p[1::4] = p[0::4] + d
    return p.astype(np.float32)


class _FarExclusions(jpkg.SystemBuilder):
    """Adds exclusions 120 atoms apart: beyond the 31-offset bit window,
    so they take the residual adjustment path."""

    def finalize(self, box, **kw):
        for i in (0, 9, 22, 131):
            self.add_exclusion(i, i + 120)
        return super().finalize(box, **kw)


def _systems(kind):
    if kind in ("drude", "residual"):
        js, pos, box = drude_water_box(
            64, None, jpkg.SystemBuilder if kind == "drude"
            else _FarExclusions)
        return js, system_from_numpy(js), _drude_positions(pos), box
    js, pos, box = make_lj_fluid(n_side=5, spacing=0.42, charge=0.4,
                                 use_pme=True)
    q = np.where(np.arange(js.n_atoms) % 2 == 0, 0.4, -0.4)
    js = js.replace(charges=q.astype(np.float32))
    rng = np.random.default_rng(2)
    pos = (pos + rng.normal(0, 0.02, pos.shape)).astype(np.float32)
    return js, system_from_numpy(js), pos, box


@pytest.mark.parametrize("kind", ["drude", "lj_fluid", "residual"])
def test_force_evaluator_matches_jax(kind, jax_pallas_interpret):
    js, ps, pos, box = _systems(kind)
    assert (js.exclusions.shape[1] > 3) == (kind == "residual")
    jf = JFE(js, pair_kernel="pallas", pallas_interpret=True, box_hint=box,
             pos_hint=pos, recip="exact")
    # the port chooses its own tile size (kernel B1 works in warps of 32,
    # not in 128-lane vectors); with the JAX evaluator's size given, the
    # sort key, capacity and nowrap axes must come out as the JAX package's
    auto = TFE(ps, pair_kernel="plist", box_hint=box, pos_hint=pos,
               device="cpu")
    assert auto.pair_ts in PLIST_TILE_SIZES and jf.pair_ts in (128, 256, 384)
    tf = TFE(ps, pair_kernel="plist", box_hint=box, pos_hint=pos,
             pair_ts=jf.pair_ts, device="cpu")
    assert (tf.pair_ts, tf.plist_sort, tf.plist_cap, tf.plist_nowrap) == (
        jf.pair_ts, jf.plist_sort, jf.plist_cap, jf.plist_nowrap)
    bj = jnp.asarray(box, jnp.float32)
    bt = torch.as_tensor(box, dtype=torch.float32)
    # the energy form's excluded-pair correction -qq erf(beta r)/r
    # cancels in float32 for a Drude pair 0.012 nm apart (~0.3 kJ/mol/nm
    # of rounding noise on both sides), so its force is compared away from
    # Drude pairs -- as tests/test_pallas.py:310-322 masks atoms in the
    # cutoff shell; the force-only form (the step's) is compared on all
    steady = np.ones(ps.n_atoms, bool)
    steady[np.asarray(ps.drude_pairs).reshape(-1)] = False
    for want_energy in (True, False):
        tj, fj = jax.jit(functools.partial(
            jf.energy_forces, want_energy=want_energy))(jnp.asarray(pos), bj)
        tt, ft = tf.energy_forces(torch.as_tensor(pos), bt,
                                  want_energy=want_energy)
        sel = steady if want_energy else slice(None)
        np.testing.assert_allclose(ft.numpy()[sel], np.asarray(fj)[sel],
                                   rtol=F_RTOL, atol=F_ATOL)
        if want_energy:
            assert set(tt) == set(tj)
            for k in tj:
                np.testing.assert_allclose(float(tt[k]), float(tj[k]),
                                           rtol=E_RTOL, atol=E_ATOL,
                                           err_msg=k)
            assert tf.group_energies(tt).keys() == jf.group_energies(tj).keys()


def _run(pkg, js, pos, box, vel, steps, jax_plist, **opts):
    """``opts`` (fold_exc14, strict_pairs, recip, pair_ts) go to both
    packages' evaluators."""
    integ = pkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
    integ.setMaxDrudeDistance(0.02)
    if pkg is jpkg:
        ctx = jpkg.Context(js, integ, positions=pos, box=box, recip="exact")
        if jax_plist:
            # the TPU path: the Pallas kernels (interpret mode here)
            ctx.evaluator = JFE(js, pair_kernel="pallas",
                                pallas_interpret=True, box_hint=box,
                                pos_hint=pos, **dict(dict(recip="exact"),
                                                     **opts))
    else:
        ctx = tpkg.Context(system_from_numpy(js), integ, positions=pos,
                           box=box, pair_kernel="plist" if jax_plist
                           else "dense", device="cpu", **opts)
    ctx.set_velocities(vel)
    traj = []
    for _ in range(steps):
        ctx.step(1)
        traj.append(np.asarray(ctx.get_positions(), np.float64))
    return np.stack(traj), ctx.potential_energy_terms(), ctx.kinetic_energy()


@pytest.mark.parametrize("path,pos_bound", [("plist", 2e-5),
                                            ("dense", 2e-4)])
def test_context_trajectory_tracks_jax(path, pos_bound,
                                      jax_pallas_interpret):
    """10 middle-scheme TGNH steps (Drude pairs, constraints, hard wall,
    exact-k Ewald).  ``plist``: the port's plist path against the JAX
    Context on its Pallas plist kernel (interpret mode) -- the TPU main
    path.  ``dense``: both on the dense sweep, whose energy-form excluded
    pair correction carries float32 cancellation noise for Drude pairs near
    their core, hence the looser bound.  Reported drift: max |dpos| per
    step; per-term |dE| after the run."""
    js, pos, box = drude_water_box(27, None, jpkg.SystemBuilder)
    pos = _drude_positions(pos, seed=3)
    rng = np.random.default_rng(5)
    vel = (rng.normal(0, 1, pos.shape) * np.sqrt(
        0.0083144626 * 333.0 * np.asarray(js.inv_masses))[:, None]
        ).astype(np.float32)
    tj, ej, kj = _run(jpkg, js, pos, box, vel, 10, path == "plist")
    tt, et, kt = _run(tpkg, js, pos, box, vel, 10, path == "plist")
    drift = np.abs(tt - tj).max(axis=(1, 2))
    print(f"\n[{path}] max |dpos| per step (nm): "
          + " ".join(f"{d:.2e}" for d in drift))
    print(f"[{path}] per-term |dE| (kJ/mol): "
          + ", ".join(f"{k} {abs(et[k] - ej[k]):.2e}" for k in ej)
          + f"; kinetic {abs(kt - kj):.2e}")
    assert drift.max() < pos_bound
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, atol=0.5,
                                   err_msg=k)
    np.testing.assert_allclose(kt, kj, rtol=1e-3)


@pytest.mark.parametrize("path,n_mol,opts", [
    ("band", 125, dict(fold_exc14=True, pair_ts=32)),
    ("strict+fused", 27, dict(strict_pairs=True, recip="exact_fused",
                              pair_ts=128))])
def test_context_routes_track_jax(path, n_mol, opts, jax_pallas_interpret):
    """10 middle-scheme TGNH steps on the band route (fold_exc14=True: the
    z-banded sweep of kernel B2, here 16 tiles of 32 atoms and the band
    width both packages size from the start configuration) and on the
    strict + fused route (the plist sweep with the exact fallback, at the
    JAX package's tile size of 128, and the reciprocal through kernels
    B4/B5), each against the JAX Context with
    the same options on its Pallas kernels in interpret mode.  Both take
    the force-only pair form in the step, so the plist bound applies:
    max |dpos| < 2e-5 nm per step, terms within 1e-3 relative / 0.5
    kJ/mol, kinetic energy within 1e-3 relative."""
    js, pos, box = drude_water_box(n_mol, None, jpkg.SystemBuilder)
    pos = _drude_positions(pos, seed=3)
    rng = np.random.default_rng(5)
    vel = (rng.normal(0, 1, pos.shape) * np.sqrt(
        0.0083144626 * 333.0 * np.asarray(js.inv_masses))[:, None]
        ).astype(np.float32)
    jf = JFE(js, pair_kernel="pallas", pallas_interpret=True, box_hint=box,
             pos_hint=pos, **dict(dict(recip="exact"), **opts))
    tf = TFE(system_from_numpy(js), box_hint=box, pos_hint=pos,
             device="cpu", **opts)
    assert (tf.pair_mode, tf.pair_ts, tf.band_w, tf.uses_band) == (
        jf.pair_mode, jf.pair_ts, jf.band_w, jf.uses_band)
    assert tf.uses_band and tf.recip_method == jf.recip_method
    tj, ej, kj = _run(jpkg, js, pos, box, vel, 10, True, **opts)
    tt, et, kt = _run(tpkg, js, pos, box, vel, 10, True, **opts)
    drift = np.abs(tt - tj).max(axis=(1, 2))
    print(f"\n[{path}] max |dpos| per step (nm): "
          + " ".join(f"{d:.2e}" for d in drift))
    print(f"[{path}] per-term |dE| (kJ/mol): "
          + ", ".join(f"{k} {abs(et[k] - ej[k]):.2e}" for k in ej)
          + f"; kinetic {abs(kt - kj):.2e}")
    assert drift.max() < 2e-5
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, atol=0.5,
                                   err_msg=k)
    np.testing.assert_allclose(kt, kj, rtol=1e-3)


@pytest.mark.parametrize("bad", ["nowrap", "capacity"])
def test_flagged_rebuild_is_refit(bad):
    """A rebuild that comes back flagged (a nowrap frame that no longer
    fits, or a list over capacity) is refitted from the current
    configuration before the list runs, so the step's forces are those of a
    correctly sized list.  (The JAX package runs the flagged list; ROADMAP
    C.)"""
    js, pos, box = drude_water_box(216, None, jpkg.SystemBuilder)
    ps = system_from_numpy(js)
    integ = tpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
    ctx = tpkg.Context(ps, integ, positions=_drude_positions(pos), box=box,
                       device="cpu")
    ev = ctx.evaluator
    if bad == "nowrap":
        ev.plist_nowrap = (True, True, True)
    else:
        ev.plist_cap = 3
    cache = ctx._fresh_cache()
    assert ctx.refits == 1 and not bool(cache.overflow)
    if bad == "nowrap":
        assert ev.plist_nowrap != (True, True, True)
    else:
        assert ev.plist_cap > 3
    st = ctx.state
    _, f_list = ev.energy_forces(st.pos, st.box, want_energy=False,
                                 pair_cache=cache)
    # against a list sized from these positions at construction
    fresh = TFE(ps, pair_kernel="plist", box_hint=box,
                pos_hint=st.pos.numpy(), device="cpu")
    _, f_ref = fresh.energy_forces(st.pos, st.box, want_energy=False)
    np.testing.assert_allclose(f_list.numpy(), f_ref.numpy(),
                               rtol=F_RTOL, atol=F_ATOL)


@pytest.mark.parametrize("ts", [32, 64])
def test_refit_pair_list_small_tiles(ts):
    """``refit_pair_list`` at the warp-sized tiles: with the capacity made
    too small and the dearer sort key set, the refit takes the cheaper key
    and grows the capacity to the candidates of the configuration
    with the usual margin, never beyond the n_tiles (n_tiles + 1) / 2 tile
    pairs there are, and the list rebuilt at that capacity is not flagged
    and gives the forces of a list sized from these positions at
    construction."""
    js, pos, box = drude_water_box(216, None, jpkg.SystemBuilder)
    ps = system_from_numpy(js)
    pos = _drude_positions(pos)
    ev = TFE(ps, pair_kernel="plist", box_hint=box, pos_hint=pos, pair_ts=ts,
             device="cpu")
    assert ev.pair_ts == ts
    pt, bt = torch.as_tensor(pos), torch.as_tensor(box, dtype=torch.float32)
    n_tiles = -(-ps.n_atoms // ts)
    bound = n_tiles * (n_tiles + 1) // 2
    assert ev.plist_cap <= bound
    # the sort key is re-chosen as well: from the dearer one back to the
    # cheaper one under the evaluator's cost model
    cost = {key: ev._plist_cost(pos, box, ts, key)[0]
            for key in ("z", "morton")}
    ev.plist_sort = max(cost, key=cost.get)
    ev.plist_cap = 3
    assert bool(ev.make_pair_cache(pt, bt).overflow)
    ev.refit_pair_list(pt, bt)
    assert ev.plist_sort == min(cost, key=cost.get)
    cache = ev.make_pair_cache(pt, bt)
    n_active = int((cache.plist & 1).sum())
    assert not bool(cache.overflow)
    assert n_active <= ev.plist_cap <= bound
    assert ev.plist_cap == min(bound, int(n_active * 1.6) + 64)
    _, f_list = ev.energy_forces(pt, bt, want_energy=False, pair_cache=cache)
    fresh = TFE(ps, pair_kernel="plist", box_hint=box, pos_hint=pos,
                pair_ts=ts, device="cpu")
    _, f_ref = fresh.energy_forces(pt, bt, want_energy=False)
    np.testing.assert_allclose(f_list.numpy(), f_ref.numpy(), rtol=F_RTOL,
                               atol=F_ATOL)
