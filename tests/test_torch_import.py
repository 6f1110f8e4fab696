"""The port imports without jax, and its host-side builder produces the JAX
builder's tables leaf for leaf; JAX containers carry across through
numpy."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu_torch.models.drude_water import drude_water_box
from openmm_velocityverlet_tpu_torch.system import (System, make_state,
                                                    state_from_numpy,
                                                    system_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    """Every module of the package, the tools subpackage, the A13 force
    terms (ops/pme.py, ops/cmap.py, ops/gb.py), the A15 loaders
    (models/prmfile, psffile, grofile, replicate), the A14 application
    layer (app) and the A17 scripts (examples.run_bulk, run_edl) included,
    imports with jax absent from sys.modules (checked in a fresh
    interpreter), and none pulls in triton."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import openmm_velocityverlet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'triton')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "assert p.__name__ + '.tools.exp_gather_kernel' in names, names\n"
        "for m in ('ops.pme', 'ops.cmap', 'ops.gb', 'models.prmfile', "
        "'models.psffile', 'models.grofile', 'models.replicate', 'app', "
        "'examples.run_bulk', 'examples.run_edl'):\n"
        "    assert p.__name__ + '.' + m in names, m\n"
        "print('ok', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("n_mol,r_cutoff", [(16, None), (27, 0.75)])
def test_builder_tables_match_jax(n_mol, r_cutoff):
    """The _drude_system layout built by both builders: identical System
    tables, leaf by leaf, and identical static fields."""
    ps, pos_p, box_p = drude_water_box(n_mol, r_cutoff, tpkg.SystemBuilder)
    js, pos_j, box_j = drude_water_box(n_mol, r_cutoff, jpkg.SystemBuilder)
    np.testing.assert_array_equal(pos_p, pos_j)
    np.testing.assert_array_equal(box_p, box_j)
    for f in dataclasses.fields(System):
        mine, ref = getattr(ps, f.name), getattr(js, f.name)
        if f.name == "gb":
            assert mine is None and ref is None
        elif isinstance(mine, np.ndarray) or hasattr(ref, "shape"):
            ref = np.asarray(ref)
            assert np.asarray(mine).dtype == ref.dtype, f.name
            np.testing.assert_array_equal(mine, ref, err_msg=f.name)
        else:
            assert mine == ref, f.name


def test_system_and_state_from_jax():
    from openmm_velocityverlet_tpu.system import make_state as jmake_state
    js, pos, box = drude_water_box(8, None, jpkg.SystemBuilder)
    ps = system_from_numpy(js)
    assert ps.n_atoms == js.n_atoms and ps.kmax == tuple(js.kmax)
    np.testing.assert_array_equal(ps.exclusions, np.asarray(js.exclusions))
    jst = jmake_state(pos, box)
    st = state_from_numpy(jst, device="cpu")
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))
    assert st.nh_eta_dot.shape == tuple(jst.nh_eta_dot.shape)
    fresh = make_state(pos, box, device="cpu")
    np.testing.assert_array_equal(fresh.pos.numpy(), st.pos.numpy())
    t = ps.to("cpu")
    assert t.exclusions.dtype.is_floating_point is False
    np.testing.assert_array_equal(t.charges.numpy(), ps.charges)


def test_entry_points_default_to_the_card():
    """Context, ForceEvaluator, make_state, state_from_numpy,
    build_constraint_data and make_barostat_state default to
    device="cuda".  Without a card that
    default raises at construction instead of running on the host; with
    one, a Context built without a device lives on it."""
    import inspect

    import torch

    from openmm_velocityverlet_tpu_torch.integrators.barostat import \
        make_barostat_state
    from openmm_velocityverlet_tpu_torch.ops.constraints import \
        build_constraint_data
    for fn in (tpkg.Context.__init__, tpkg.ForceEvaluator.__init__,
               make_state, state_from_numpy, build_constraint_data,
               make_barostat_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    ps, pos, box = drude_water_box(8)
    integ = tpkg.VVIntegrator()
    if torch.cuda.is_available():
        ctx = tpkg.Context(ps, integ, positions=pos, box=box)
        assert ctx.state.pos.is_cuda and ctx.evaluator.t.charges.is_cuda
        return
    fresh = make_state(pos, box, device="cpu")
    for build in (
            lambda: tpkg.Context(ps, integ, positions=pos, box=box),
            lambda: tpkg.ForceEvaluator(ps, box_hint=box, pos_hint=pos),
            lambda: make_state(pos, box),
            lambda: state_from_numpy(fresh),
            lambda: build_constraint_data(ps.constraints,
                                          ps.constraint_dist,
                                          ps.inv_masses),
            lambda: make_barostat_state(1.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_unported_features_raise(tmp_path):
    ps, pos, box = drude_water_box(8)
    # the integrator features of ROADMAP A10 are ported: Langevin, the
    # E-field, cosine acceleration and the vanilla VV scheme construct
    cases = {
        "Langevin": lambda i: [i.addParticleLangevin(k) for k in range(4)],
        "E-field": lambda i: (i.addParticleElectrolyte(0),
                              i.setElectricField(0.5)),
        "cosine": lambda i: i.setCosAcceleration(0.1),
        "VV step": lambda i: i.setUseMiddleScheme(False),
    }
    for label, setup in cases.items():
        integ = tpkg.VVIntegrator(300.0, 10.0, 1.0, 40.0, 0.001)
        setup(integ)
        ctx = tpkg.Context(ps, integ, positions=pos, box=box, device="cpu")
        ctx.step(1)
        assert np.isfinite(ctx.get_positions()).all(), label
    b = tpkg.SystemBuilder()
    b.add_particle(10.0, charge=0.5)
    b.add_particle(0.0, charge=-0.5)
    b.set_lj_from_type_params([0.3], [0.1])
    img_box = np.array([2.0, 2.0, 2.0])
    img_sys = b.finalize(img_box, r_cutoff=0.8)
    # image pairs, external forces and the barostat are ported (A11, A12)
    integ = tpkg.VVIntegrator()
    integ.setMirrorLocation(1.0)
    integ.addImagePair(1, 0)
    ctx = tpkg.Context(img_sys, integ, positions=[[0.5, 0.5, 0.5],
                                                  [0.5, 0.5, 1.5]],
                       box=img_box, device="cpu",
                       external_forces=[lambda p, b: 0.0 * p.sum()],
                       barostat=tpkg.BarostatConfig("iso", 1.0, 300.0, 1))
    assert ctx.image_mirror == (1, 0, 1, 1.0)
    ctx.step(1)
    assert "external_0" in ctx.potential_energy_terms()
    assert ctx.baro_attempts == 1
    integ = tpkg.VVIntegrator()
    # the mesh (A16) is ported: a world of one under gloo on the CPU
    # constructs and steps (its split sweep needs an eligible band, hence
    # the larger box and 32-atom tiles)
    from openmm_velocityverlet_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(size=1, device="cpu", rank=0,
                     init_method=f"file://{tmp_path}/store")
    try:
        mps, mpos, mbox = drude_water_box(125)
        ctx = tpkg.Context(mps, tpkg.VVIntegrator(), positions=mpos,
                           box=mbox, pair_ts=32, mesh=mesh, device="cpu")
        assert (ctx.mesh.size, ctx.evaluator.pairs.mode) == (1, "band")
        ctx.step(1)
        assert np.isfinite(ctx.get_positions()).all()
    finally:
        torch.distributed.destroy_process_group()
    # PME and "auto" (A13) construct and step
    for recip in ("pme", "auto"):
        ctx = tpkg.Context(ps, tpkg.VVIntegrator(), positions=pos, box=box,
                           device="cpu", recip=recip)
        assert ctx.evaluator.recip_method in ("pme", "exact")
        ctx.step(1)
        assert np.isfinite(ctx.get_positions()).all(), recip
    # "band" names no pair kernel: the z-band sweep is fold_exc14=True
    with pytest.raises(ValueError, match="fold_exc14"):
        tpkg.Context(ps, integ, positions=pos, box=box, device="cpu",
                     pair_kernel="band")
    # the band, strict and fused routes are ported (kernels B2, B4, B5)
    for kw, mode in ((dict(fold_exc14=True), "band"),
                     (dict(strict_pairs=True), "plist"),
                     (dict(recip="exact_fused"), "plist")):
        ctx = tpkg.Context(ps, integ, positions=pos, box=box, device="cpu",
                           **kw)
        assert ctx.evaluator.pairs.mode == mode
        assert ctx.evaluator.pairs.host_flag == kw.get("strict_pairs", False)
        assert ctx.evaluator.recip_method == kw.get("recip", "exact")
    # CMAP (A13) builds, and its term is in the evaluation
    b = tpkg.SystemBuilder()
    for _ in range(5):
        b.add_particle(12.0)
    b.set_lj_from_type_params([0.3], [0.1])
    b.add_cmap_term((0, 1, 2, 3, 1, 2, 3, 4),
                    b.add_cmap_map(np.ones((24, 24))))
    cmap_box = np.array([2.0, 2.0, 2.0])
    cmap_sys = b.finalize(cmap_box)
    ctx = tpkg.Context(cmap_sys, tpkg.VVIntegrator(), positions=[
        [0.0, 0.1, 0.0], [0.15, 0.0, 0.0], [0.3, 0.1, 0.05],
        [0.45, 0.05, -0.05], [0.6, 0.15, 0.02]], box=cmap_box, device="cpu")
    ctx.step(1)
    np.testing.assert_allclose(ctx.potential_energy_terms()["cmap"], 1.0,
                               rtol=1e-5)
