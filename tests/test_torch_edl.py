"""Constant voltage in the port against the JAX package, on the same numpy
inputs: the image-mirror reciprocal and its layout detection, the external
force closures, the ommhelper helpers, the EDL analysis functions, and
20-step Context runs of the run-edl wiring (tests/test_edl.build_edl) in
the middle and the vanilla VV scheme.

Tolerances: the mirror reciprocal as tests/test_ewald_mirror.py:48-54
(energy rtol 2e-5, real-atom gradient rtol 1e-4 / atol 2e-4 max|g|, image
rows exactly 0); external energies rtol 1e-5 and forces as
tests/test_external.py:166-173; the analysis functions (float64 numpy in
both packages) 1e-12 relative; trajectories as
test_torch_integrator.test_context_trajectory_tracks_jax (|dpos| < 2e-5 nm
a step, terms 1e-3 relative / 0.5 kJ/mol)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu import edl_analysis as jea
from openmm_velocityverlet_tpu.forces import ForceEvaluator as JFE
from openmm_velocityverlet_tpu.models import helper as jhelper
from openmm_velocityverlet_tpu.ops import ewald as jewald
from openmm_velocityverlet_tpu.ops import external as jext
from openmm_velocityverlet_tpu_torch import edl_analysis as tea
from openmm_velocityverlet_tpu_torch.context import image_mirror
from openmm_velocityverlet_tpu_torch.models import helper as thelper
from openmm_velocityverlet_tpu_torch.ops import ewald as tewald
from openmm_velocityverlet_tpu_torch.ops import external as text
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from tests.test_edl import build_edl
from tests.test_edl_analysis import LZ, NBIN, _sheet_rho
from tests.test_ewald_mirror import _mirrored_system
from tests.test_torch_slice import jax_pallas_interpret  # noqa: F401

BETA, KMAX = 2.2, (5, 5, 9)


def _port_recip(pos, q, box, mirror=None, chunk=0, dtype=torch.float32,
                scale=1.0):
    p = torch.tensor(pos, dtype=dtype, requires_grad=True)
    e = tewald.reciprocal_energy(p, torch.tensor(box, dtype=dtype),
                                 torch.tensor(q), BETA, KMAX, chunk=chunk,
                                 mirror=mirror)
    (g,) = torch.autograd.grad(e, p, grad_outputs=torch.tensor(
        scale, dtype=dtype))
    return float(e.detach()), g.numpy()


def _reference_recip(pos, q, box, mirror=None):
    """float64 autograd of the same energy, one contraction."""
    p = torch.tensor(pos, dtype=torch.float64, requires_grad=True)
    e = tewald.reciprocal_energy_reference(
        p, torch.tensor(box, dtype=torch.float64), torch.tensor(q), BETA,
        KMAX, mirror=mirror)
    (g,) = torch.autograd.grad(e, p)
    return float(e.detach()), g.numpy()


def _assert_mirror_close(e, g, e_ref, g_ref, n_real):
    np.testing.assert_allclose(e, e_ref, rtol=2e-5)
    scale = np.abs(g_ref[:n_real]).max()
    np.testing.assert_allclose(g[:n_real], g_ref[:n_real], rtol=1e-4,
                               atol=2e-4 * scale)
    assert np.abs(g[n_real:]).max() == 0.0


@pytest.mark.parametrize("chunk, lz", [
    pytest.param(0, 8.0, id="0"), pytest.param(64, 8.0, id="64"),
    pytest.param(0, 3.1, id="0-cubic"), pytest.param(64, 3.1, id="64-cubic")])
def test_mirror_reciprocal_matches_jax_and_explicit(chunk, lz):
    """The mirror route's closed form against the explicit 2N route, JAX's
    mirror route and float64 autograd of the same energy, in a slab box and
    a cubic one, through one contraction or forced chunks: image rows
    exactly 0, the backward scaled by the incoming gradient, and the
    counters."""
    pos, q, box, mirror = _mirrored_system(np.random.default_rng(7), lz=lz)
    calls = tewald.reciprocal_energy.calls
    chunks = tewald.reciprocal_energy.chunked_calls
    e_m, g_m = _port_recip(pos, q, box, mirror, chunk)
    e_x, g_x = _port_recip(pos, q, box, None, chunk)
    n_real = mirror[0]
    _assert_mirror_close(e_m, g_m, e_x, g_x, n_real)
    e_j, g_j = jax.value_and_grad(lambda p: jewald.reciprocal_energy(
        p, jnp.asarray(box), jnp.asarray(q), BETA, KMAX, chunk=chunk,
        chunk_min_bytes=0.0, mirror=mirror))(jnp.asarray(pos))
    _assert_mirror_close(e_m, g_m, float(e_j), np.asarray(g_j), n_real)
    e_r, g_r = _reference_recip(pos, q, box, mirror)
    _assert_mirror_close(e_m, g_m, e_r, g_r, n_real)
    assert np.abs(g_r[n_real:]).max() == 0.0
    # in float64 the closed form is the autograd gradient to rounding, and
    # its backward scales with the incoming gradient
    e_c, g_c = _port_recip(pos, q, box, mirror, chunk, torch.float64, -3.0)
    np.testing.assert_allclose(e_c, e_r, rtol=1e-12)
    np.testing.assert_allclose(g_c, -3.0 * g_r, rtol=1e-9,
                               atol=1e-12 * np.abs(g_r).max())
    assert np.abs(g_c[n_real:]).max() == 0.0
    assert tewald.reciprocal_energy.calls == calls + 3
    assert tewald.reciprocal_energy.chunked_calls == chunks + 3 * (chunk > 0)


def _mirror_layout(kind, rng):
    """(pos, q, box, image pairs, mirror_z) of _mirrored_system's layout:
    "contiguous" as it is; "gap" with 12 charged atoms between the parents
    and the images; "sign" with one image charge equal to its parent's."""
    pos, q, box, (img0, par0, cnt, zm) = _mirrored_system(rng)
    if kind == "gap":
        extra = rng.uniform(0, 1, (12, 3)) * [3.1, 3.1, 2.8] + [0, 0, 0.5]
        pos = np.concatenate([pos[:img0], extra, pos[img0:]]).astype(
            np.float32)
        q = np.concatenate([q[:img0], rng.normal(0, 0.5, 12), q[img0:]]
                           ).astype(np.float32)
        img0 += 12
    elif kind == "sign":
        q = q.copy()
        q[img0 + 5] = q[par0 + 5]
    pairs = np.stack([np.arange(img0, img0 + cnt),
                      np.arange(par0, par0 + cnt)], 1)
    return pos, q, box, pairs, zm


def _layout_systems(pos, q, box, pairs, zm):
    """The JAX and port Contexts of one layout: charges only, images
    massless (VVIntegrator.addImagePair + setMirrorLocation)."""
    out = []
    for pkg in (jpkg, tpkg):
        b = pkg.SystemBuilder()
        img = set(pairs[:, 0].tolist())
        for i, qi in enumerate(q):
            b.add_particle(0.0 if i in img else 12.0, charge=float(qi))
        b.set_lj_from_type_params([0.3], [0.0])
        system = b.finalize(box, r_cutoff=1.0)
        integ = pkg.VVIntegrator()
        integ.setMirrorLocation(zm)
        for i, p in pairs:
            integ.addImagePair(int(i), int(p))
        kw = dict(device="cpu") if pkg is tpkg else dict(recip="exact")
        out.append(pkg.Context(system, integ, positions=pos, box=box, **kw))
    return out


@pytest.mark.parametrize("kind", ["contiguous", "gap", "sign"])
def test_mirror_detection_falls_back_off_layout(kind):
    """The port takes the mirror only on the contiguous layout with
    q_img = -q_parent; elsewhere its Context's reciprocal is the explicit
    evaluation over all atoms.  The JAX detection admits the gap and the
    wrong sign, and on the gap its mirror route drops the atoms between
    parents and images."""
    pos, q, box, pairs, zm = _mirror_layout(kind, np.random.default_rng(9))
    jctx, tctx = _layout_systems(pos, q, box, pairs, zm)
    j_mirror = jctx.evaluator.image_mirror
    assert j_mirror is not None
    mirror = image_mirror(tctx.data, tctx.system.charges)
    assert tctx.image_mirror == mirror
    assert tctx.evaluator.image_mirror == mirror
    s = tctx.system
    e_port = tctx.potential_energy_terms()["coul_recip"]
    e_explicit = float(jewald.reciprocal_energy(
        jnp.asarray(pos), jnp.asarray(box), jnp.asarray(s.charges),
        s.ewald_beta, s.kmax))
    np.testing.assert_allclose(e_port, e_explicit, rtol=2e-5)
    if kind == "contiguous":
        assert mirror == j_mirror
        return
    assert mirror is None
    e_jax_mirror = float(jewald.reciprocal_energy(
        jnp.asarray(pos), jnp.asarray(box), jnp.asarray(s.charges),
        s.ewald_beta, s.kmax, mirror=j_mirror))
    miss = abs(e_jax_mirror - e_explicit) / abs(e_explicit)
    print(f"\n[{kind}] JAX mirror route {e_jax_mirror:.4f}, explicit "
          f"{e_explicit:.4f} (relative miss {miss:.2e}); port {e_port:.4f}")
    if kind == "gap":
        assert miss > 1e-3
    with pytest.raises(ValueError, match="trailing block"):
        tewald.reciprocal_energy(torch.tensor(pos), torch.tensor(box),
                                 torch.tensor(q), BETA, KMAX,
                                 mirror=(pairs[0, 0] + 1, pairs[0, 1],
                                         len(pairs) - 1, zm))


def _closures(mod, pos, q, parts, box):
    lz = float(box[2])
    return {
        "spring_self": mod.spring_self(parts, pos, [100.0, 50.0, 200.0]),
        "wall_power": mod.wall_power(parts, 2, (0.0, lz), k=3.0, cutoff=0.5,
                                     power=3),
        "wall_lj126": mod.wall_lj126(parts, 2, (0.0, lz), epsilon=2.0,
                                     sigma=0.3),
        "electric_field_force": mod.electric_field_force(
            parts, q, [0.3, -0.2, 2.0]),
        "slab_correction": mod.slab_correction(q),
        "restrain_particle_number": mod.restrain_particle_number(
            parts, 2, (0.5, 2.0), 0.1, 5.0, 7.0, weights=np.linspace(
                0.5, 1.5, len(parts))),
    }


@pytest.mark.parametrize("name", [
    "spring_self", "wall_power", "wall_lj126", "electric_field_force",
    "slab_correction", "restrain_particle_number"])
def test_external_closures_match_jax(name):
    """Energies and forces of each closure at positions where it is
    active (every third atom, half of them within 0.3 nm of a z wall);
    ``analytic_force`` where the closure has one, else autograd."""
    rng = np.random.default_rng(3)
    n = 40
    pos = rng.uniform(0.2, 2.8, (n, 3)).astype(np.float32)
    pos[0:n:6, 2] = rng.uniform(0.05, 0.3, len(range(0, n, 6)))
    pos[3:n:6, 2] = rng.uniform(2.7, 2.95, len(range(3, n, 6)))
    box = np.array([3.0, 3.0, 3.0], np.float32)
    q = rng.normal(0, 0.5, n).astype(np.float32)
    parts = list(range(0, n, 3))
    ref_pos = pos - 0.03
    fj = _closures(jext, ref_pos, q, parts, box)[name]
    ft = _closures(text, ref_pos, q, parts, box)[name]
    jp, jb = jnp.asarray(pos), jnp.asarray(box)
    tp, tb = torch.tensor(pos, requires_grad=True), torch.tensor(box)
    e_j = float(fj(jp, jb))
    e_t = ft(tp, tb)
    assert e_j != 0.0
    np.testing.assert_allclose(float(e_t), e_j, rtol=1e-5)
    assert hasattr(ft, "analytic_force") == hasattr(fj, "analytic_force")
    if hasattr(fj, "analytic_force"):
        f_j = np.asarray(fj.analytic_force(jp, jb))
        f_t = ft.analytic_force(tp.detach(), tb).numpy()
    else:
        f_j = -np.asarray(jax.grad(lambda p: fj(p, jb))(jp))
        f_t = -torch.autograd.grad(e_t, tp)[0].numpy()
    assert np.abs(f_j).max() > 0
    rtol, atol = (1e-4, 1e-3) if name.startswith("wall") else (1e-5, 1e-4)
    np.testing.assert_allclose(f_t, f_j, rtol=rtol, atol=atol)


def test_mirror_image_exclusions_stub():
    """tests/test_edl.py:130-148 on the port's helper."""
    b = types.SimpleNamespace(exclusions={(0, 1), (0, 2)},
                              exceptions={(1, 2): (0.25, 0.3, 0.5)})
    added_exc, added_exn = [], []
    b.add_exclusion = lambda i, j: added_exc.append((i, j))
    b.add_exception = lambda i, j, qq, s, e: added_exn.append(
        (i, j, qq, s, e))
    thelper.mirror_image_exclusions(types.SimpleNamespace(builder=b),
                                    [(0, 10), (1, 11), (2, 12)])
    assert set(added_exc) == {(10, 11), (10, 12)}
    assert added_exn == [(11, 12, 0.25, 0.1, 0.0)]


def _helper_layout(pkg, helper):
    """Ion pairs with Drudes, a hydroxyl-like donor, an exception, and one
    massless image per liquid atom, wired by all five helpers."""
    b = pkg.SystemBuilder()
    liquid = []
    for m in range(4):
        c = b.add_particle(39.0, charge=1.8, lj_type=1)
        d = b.add_particle(0.4, charge=-0.8, lj_type=2)
        b.add_drude(d, c, -1, -1, -1, -0.8, 1e-3, 1.0, 1.0)
        a = b.add_particle(35.0, charge=-1.0, lj_type=1)
        h = b.add_particle(1.0, charge=0.0, lj_type=2)
        b.add_bond(a, h, 0.1, 1000.0)
        b.add_exclusion(c, d)
        b.add_exception(c, a, 0.5 * 1.8 * -1.0, 0.3, 0.2)
        liquid += [c, d, a, h]
    pairs = [(p, b.add_particle(1.0, charge=0.0, lj_type=3))
             for p in liquid]
    b.set_lj_from_type_params([0.3, 0.35, 0.1, 0.1], [0.6, 0.4, 0.0, 0.0])
    built = types.SimpleNamespace(builder=b)
    groups = np.zeros(len(b.masses), np.int32)
    groups[[i for _, i in pairs]] = 1
    helper.add_clpol_coul_tt(built, [3, 7], b=40.0, cutoff=1.0)
    helper.assign_image_charges(built, pairs)
    helper.mirror_image_exclusions(built, pairs)
    helper.set_lj_interaction_groups(built, groups, [(0, 0), (1, 0)])
    helper.add_molecule_links(built, pairs)
    return b.finalize(np.array([3.0, 3.0, 6.0]), r_cutoff=1.0)


def test_helpers_on_builders_match_jax():
    import dataclasses
    ps = _helper_layout(tpkg, thelper)
    js = _helper_layout(jpkg, jhelper)
    for f in dataclasses.fields(tpkg.System):
        mine, ref = getattr(ps, f.name), getattr(js, f.name)
        if f.name == "gb":
            assert mine is None and ref is None
        elif isinstance(mine, np.ndarray) or hasattr(ref, "shape"):
            np.testing.assert_array_equal(mine, np.asarray(ref),
                                          err_msg=f.name)
        else:
            assert mine == ref, f.name
    assert ps.masses[-1] == 0.0 and ps.charges[-16] == -ps.charges[0]
    assert ps.lj_group_allowed.shape == (2, 2)


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _close(x, y)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


@pytest.mark.parametrize("sheets", [
    [],
    [(1.525, 0.37), (6.475, -0.37), (14.475, -0.37), (9.525, 0.37)],
    [(1.525, 0.37), (6.475, -0.37)],
    [(0.425, -0.3), (7.575, 0.3), (15.575, 0.3), (8.425, -0.3)]])
def test_edl_analysis_matches_jax(sheets):
    rho = _sheet_rho(sheets) if sheets else np.zeros(NBIN)
    for v in (1.0, 0.5):
        prof = tea.poisson_profile(rho, LZ, v)
        _close(prof, jea.poisson_profile(rho, LZ, v))
        _close(tea.capacitance_plane_field(prof, v),
               jea.capacitance_plane_field(prof, v))
    _close(tea.antisymmetry_residual(rho), jea.antisymmetry_residual(rho))
    z = np.array([s[0] for s in sheets] or [1.0])
    q = np.array([s[1] for s in sheets] or [0.2])
    args = (z, q, z < LZ / 2, LZ / 2, 1.0, 2.5)
    _close(tea.capacitance_dipole(*args), jea.capacitance_dipole(*args))
    assert tea.EPS0 == jea.EPS0


class _JaxDraws:
    """The JAX Langevin draws of one step, handed to the port Context in
    place of its generator's: the step's key split as in the JAX step
    (``key, k_l = split(rng_key)``) and k_l split in two as
    langevin_ou_update / langevin_extra_force do."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, *shapes):
        self.key, k_l = jax.random.split(self.key)
        return [torch.tensor(np.asarray(jax.random.normal(k, s, jnp.float32)))
                for k, s in zip(jax.random.split(k_l), shapes)]


def _edl_run(pkg, middle, steps):
    """The tests/test_edl.py wiring on build_edl(): Langevin electrode,
    image pairs and mirror, the E-field, the spring restraint and the Drude
    wall; ``steps`` single steps.  Returns positions per step, the terms,
    the group energies and the Context."""
    system, pos, box, lz, elec, ils, drudes, image_pairs = build_edl()
    ext = jext if pkg is jpkg else text
    externals = [ext.spring_self(elec, pos, [400.0, 400.0, 2000.0]),
                 ext.wall_lj126(drudes, 2, (0.0, lz / 2), epsilon=2.0,
                                sigma=0.15)]
    integ = pkg.VVIntegrator(300.0, 10.0, 1.0, 40.0, 0.001)
    integ.setMaxDrudeDistance(0.02)
    integ.setUseMiddleScheme(middle)
    for i in elec:
        integ.addParticleLangevin(i)
    integ.setMirrorLocation(lz / 2)
    for parent, image in image_pairs:
        integ.addImagePair(image, parent)
    integ.setElectricField(2.0 / lz * 2)
    for i in ils:
        integ.addParticleElectrolyte(i)
    rng = np.random.default_rng(5)
    vel = (rng.normal(0, 1, pos.shape) * np.sqrt(
        0.0083144626 * 300.0 * np.asarray(system.inv_masses))[:, None]
        ).astype(np.float32)
    if pkg is jpkg:
        ctx = jpkg.Context(system, integ, positions=pos, box=box,
                           external_forces=externals, recip="exact")
        ctx.evaluator = JFE(system, externals, pair_kernel="pallas",
                            pallas_interpret=True, box_hint=box,
                            pos_hint=pos, recip="exact",
                            image_mirror=ctx.evaluator.image_mirror)
    else:
        ctx = tpkg.Context(system_from_numpy(system), integ, positions=pos,
                           box=box, external_forces=externals,
                           pair_kernel="plist", device="cpu")
        ctx._draws = _JaxDraws(integ.random_number_seed)
    ctx.set_velocities(vel)
    traj = []
    for _ in range(steps):
        ctx.step(1)
        traj.append(np.asarray(ctx.get_positions(), np.float64))
    return (np.stack(traj), ctx.potential_energy_terms(),
            ctx.group_energies(), ctx)


@pytest.mark.parametrize("middle", [True, False], ids=["middle", "vv"])
def test_edl_context_tracks_jax(middle, jax_pallas_interpret):
    tj, ej, gj, jctx = _edl_run(jpkg, middle, 20)
    tt, et, gt, tctx = _edl_run(tpkg, middle, 20)
    assert tctx.image_mirror == jctx.evaluator.image_mirror is not None
    assert tctx.evaluator.pairs.inert is not None
    drift = np.abs(tt - tj).max(axis=(1, 2))
    print("\nmax |dpos| per step (nm): "
          + " ".join(f"{d:.2e}" for d in drift))
    assert drift.max() < 2e-5
    assert ej.keys() == et.keys()
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, atol=0.5,
                                   err_msg=k)
    assert {"external_0", "external_1"} <= set(et)
    assert et["external_0"] > 0
    np.testing.assert_allclose(gt[0], et["external_0"] + et["external_1"],
                               rtol=1e-6)
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-3, atol=0.5)
    p = tt[-1]
    pairs = np.asarray(tctx.data.image_pairs)
    img, par = pairs[:, 0], pairs[:, 1]
    zm = tctx.data.mirror_location
    np.testing.assert_allclose(p[img, :2], p[par, :2], atol=1e-5)
    np.testing.assert_allclose(p[img, 2], 2 * zm - p[par, 2], atol=1e-5)
