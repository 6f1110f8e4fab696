"""The port imports without jax, and its host-side builder produces the JAX
builder's tables leaf for leaf; JAX containers carry across through
numpy."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu_torch.models.drude_water import drude_water_box
from openmm_velocityverlet_tpu_torch.system import (System, make_state,
                                                    state_from_numpy,
                                                    system_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    """Every module of the package imports with jax absent from
    sys.modules (checked in a fresh interpreter), and none pulls in
    triton."""
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
    """Context, ForceEvaluator, make_state, state_from_numpy and
    build_constraint_data default to device="cuda".  Without a card that
    default raises at construction instead of running on the host; with
    one, a Context built without a device lives on it."""
    import inspect

    import torch

    from openmm_velocityverlet_tpu_torch.ops.constraints import \
        build_constraint_data
    for fn in (tpkg.Context.__init__, tpkg.ForceEvaluator.__init__,
               make_state, state_from_numpy, build_constraint_data):
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
                                          ps.inv_masses)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_unported_features_raise():
    ps, pos, box = drude_water_box(8)
    cases = {
        "A10": lambda i: i.addParticleLangevin(0) and
        [i.addParticleLangevin(k) for k in (1, 2, 3)],
        "E-field": lambda i: (i.addParticleElectrolyte(0),
                              i.setElectricField(0.5)),
        "cosine": lambda i: i.setCosAcceleration(0.1),
        "VV step": lambda i: i.setUseMiddleScheme(False),
    }
    for label, setup in cases.items():
        integ = tpkg.VVIntegrator(300.0, 10.0, 1.0, 40.0, 0.001)
        setup(integ)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpkg.Context(ps, integ, positions=pos, box=box, device="cpu")
    b = tpkg.SystemBuilder()
    b.add_particle(10.0, charge=0.5)
    b.add_particle(0.0, charge=-0.5)
    b.set_lj_from_type_params([0.3], [0.1])
    img_box = np.array([2.0, 2.0, 2.0])
    img_sys = b.finalize(img_box, r_cutoff=0.8)
    integ = tpkg.VVIntegrator()
    integ.addImagePair(1, 0)
    with pytest.raises(NotImplementedError, match="A11"):
        tpkg.Context(img_sys, integ, positions=[[0.5, 0.5, 0.5],
                                                [0.5, 0.5, 1.5]],
                     box=img_box, device="cpu")
    integ = tpkg.VVIntegrator()
    for kw in (dict(recip="pme"), dict(barostat=object()),
               dict(mesh=object()),
               dict(external_forces=[lambda p, b: 0.0])):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpkg.Context(ps, integ, positions=pos, box=box, device="cpu",
                         **kw)
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
        assert ctx.evaluator.pair_mode == mode
        assert ctx.evaluator.strict_pairs == kw.get("strict_pairs", False)
        assert ctx.evaluator.recip_method == kw.get("recip", "exact")
    b = tpkg.SystemBuilder()
    b.add_particle(1.0)
    b.add_cmap_map(np.zeros((24, 24)))
    with pytest.raises(NotImplementedError, match="CMAP"):
        b.finalize(np.array([2.0, 2.0, 2.0]))
