"""The port's loaders (models/prmfile.py, psffile.py, grofile.py,
replicate.py) against the JAX package's, on files the tests write: the
NBTHOLE fixture of tests/test_nbthole.py, the CMAP parameters of
tests/test_cmap.py, chip_smoke.py's Drude fixture with NBTHOLE and CMAP
(plain, with implicit solvent), a written .gro, and replicate on
tests/test_replicate.py's charged fluid; and the slice as a whole, that
fixture loaded and stepped by each package's Context."""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from openmm_velocityverlet_tpu.models.grofile import GroFile as JGro
from openmm_velocityverlet_tpu.models.prmfile import CharmmParameterSet as JPrm
from openmm_velocityverlet_tpu.models.psffile import OplsPsfFile as JPsf
from openmm_velocityverlet_tpu.models.replicate import replicate as jreplicate
from openmm_velocityverlet_tpu_torch.forces import ForceEvaluator as TFE
from openmm_velocityverlet_tpu_torch.models.grofile import GroFile as TGro
from openmm_velocityverlet_tpu_torch.models.prmfile import \
    CharmmParameterSet as TPrm
from openmm_velocityverlet_tpu_torch.models.psffile import OplsPsfFile as TPsf
from openmm_velocityverlet_tpu_torch.models.replicate import \
    replicate as treplicate
from openmm_velocityverlet_tpu_torch.system import System, system_from_numpy
from tests.test_nbthole import _write_nbthole_fixture
from tests.test_replicate import _charged_fluid


def assert_systems_equal(mine, ref):
    """Every System field equal, dtype included; a GB block leaf by
    leaf."""
    for f in dataclasses.fields(System):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name == "gb":
            assert (a is None) == (b is None)
            if b is not None:
                for k in ("radii", "or_radii", "sr_radii"):
                    np.testing.assert_array_equal(
                        getattr(a, k).numpy(), np.asarray(getattr(b, k)))
                for k in ("model", "solute_dielectric", "solvent_dielectric",
                          "kappa", "sasa", "cutoff"):
                    assert getattr(a, k) == getattr(b, k), k
        elif hasattr(b, "shape"):
            b = np.asarray(b)
            assert np.asarray(a).dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _load_both(psf_p, prm_p, box, **create):
    out = []
    for psf_cls, prm_cls in ((TPsf, TPrm), (JPsf, JPrm)):
        psf = psf_cls(psf_p, periodicBoxVectors=np.diag(box))
        out.append(psf.createSystem(prm_cls(prm_p), **create))
    return out


def _assert_built_equal(mine, ref):
    assert_systems_equal(mine.system, ref.system)
    for k in ("atom_names", "atom_types", "residue_ids", "residue_names",
              "segment_ids"):
        assert getattr(mine.topology, k) == getattr(ref.topology, k), k
    for k in ("bonds", "angles", "dihedrals", "impropers", "cmaps",
              "drude_pair_list", "lonepairs", "aniso_list"):
        assert getattr(mine.psf, k) == getattr(ref.psf, k), k


def test_nbthole_fixture_createsystem_matches_jax(tmp_path):
    """tests/test_nbthole._write_nbthole_fixture through createSystem:
    every System field, the topology and the parsed tables equal."""
    psf_p, prm_p = _write_nbthole_fixture(str(tmp_path))
    mine, ref = _load_both(psf_p, prm_p, np.array([5.0, 5.0, 5.0]),
                           nonbondedCutoff=1.2, constraints=None,
                           rigidWater=False)
    _assert_built_equal(mine, ref)
    assert int(np.max(mine.system.nbt_idx)) == 2


def test_cmap_prm_matches_jax(tmp_path):
    """tests/test_cmap.py:98-117's CMAP parameters: the same resolution and
    grid, the reversed halves resolve to the same map, an unknown key
    raises KeyError."""
    R = 4
    vals = np.arange(R * R, dtype=float) * 0.25
    lines = ["CMAP", "CA CB CC CD CE CF CG CH 4"]
    for r in range(R):
        lines.append(" ".join(f"{v:.3f}" for v in vals[r * R:(r + 1) * R]))
    lines += ["", "END"]
    p = tmp_path / "cmap.prm"
    p.write_text("\n".join(lines) + "\n")
    mine, ref = TPrm(str(p)), JPrm(str(p))
    types = ("CA", "CB", "CC", "CD", "CE", "CF", "CG", "CH")
    for t8 in (types, ("CD", "CC", "CB", "CA", "CH", "CG", "CF", "CE")):
        res, grid = mine.cmap(*t8)
        res_j, grid_j = ref.cmap(*t8)
        assert res == res_j == R
        np.testing.assert_array_equal(grid, grid_j)
    assert mine.cmap_types.keys() == ref.cmap_types.keys()
    with pytest.raises(KeyError):
        mine.cmap("CA", "CB", "CC", "CD", "CE", "CF", "CG", "ZZ")


@pytest.mark.parametrize("create", [
    dict(nonbondedCutoff=1.0, constraints=None, rigidWater=False),
    dict(nonbondedCutoff=1.0, constraints=None, rigidWater=False,
         use_pme=False, implicitSolvent="OBC2",
         implicitSolventSaltConc=0.15, gbsaModel="ACE"),
    dict(nonbondedCutoff=1.0, constraints=None, rigidWater=False,
         use_pme=False, implicitSolvent="HCT", switchDistance=0.8)],
    ids=["pme", "gb_obc2_ace", "gb_hct_switch"])
def test_charmm_fixture_matches_jax(tmp_path, create):
    """chip_smoke.write_charmm_fixture (8 cells: Drude pairs with NBTHOLE,
    chains with CMAP) through both loaders: the same System (with its GB
    block) and topology; the .gro it writes reads the same."""
    psf_p, prm_p, gro_p = chip_smoke.write_charmm_fixture(str(tmp_path), 2)
    gro, gro_j = TGro(gro_p), JGro(gro_p)
    np.testing.assert_array_equal(gro.positions, gro_j.positions)
    np.testing.assert_array_equal(gro.box, gro_j.box)
    mine, ref = _load_both(psf_p, prm_p, gro.box, **create)
    _assert_built_equal(mine, ref)
    s = mine.system
    assert s.cmap_atoms.shape == (8, 8) and s.cmap_coeffs.shape[0] == 1
    assert int(np.max(s.nbt_idx)) == 2 and s.drude_pairs.shape[0] == 16
    assert (s.gb is not None) == ("implicitSolvent" in create)


def test_gro_write_and_read_match_jax(tmp_path):
    """A frame with velocities written by both writers (the same lines
    after the title) and read by both readers: the same positions,
    velocities, box and names."""
    rng = np.random.default_rng(3)
    n = 37
    top = type("Top", (), dict(
        atom_names=[f"A{k % 7}" for k in range(n)],
        residue_names=[("RES", "SOL")[k % 2] for k in range(n)],
        residue_ids=np.arange(n) // 3 + 1))
    pos = rng.uniform(0, 4.5, (n, 3))
    vel = rng.normal(0, 0.5, (n, 3))
    box = np.array([4.5, 4.6, 4.7])
    texts = []
    for cls in (TGro, JGro):
        path = str(tmp_path / f"{cls.__module__.split('.')[0]}.gro")
        cls.writeFile(top, pos, box, path, time=1.5, velocities=vel)
        texts.append(open(path).read().splitlines())
    assert texts[0][1:] == texts[1][1:]
    for path in (tmp_path / "openmm_velocityverlet_tpu.gro",
                 tmp_path / "openmm_velocityverlet_tpu_torch.gro"):
        mine, ref = TGro(str(path)), JGro(str(path))
        np.testing.assert_array_equal(mine.positions, ref.positions)
        np.testing.assert_array_equal(mine.velocities, ref.velocities)
        np.testing.assert_array_equal(mine.box, ref.box)
        np.testing.assert_array_equal(mine.residue_ids, ref.residue_ids)
        assert (mine.atom_names, mine.residue_names) == (
            ref.atom_names, ref.residue_names)
        np.testing.assert_allclose(mine.positions, pos, atol=5e-4)


@pytest.mark.parametrize("factors", [(1, 2, 2), (2, 1, 1)])
def test_replicate_matches_jax(factors):
    """replicate on test_replicate._charged_fluid: the same tables,
    positions and box as the JAX replicate."""
    js, pos, box = _charged_fluid()
    ps = system_from_numpy(js)
    rs, rpos, rbox = treplicate(ps, pos, box, factors)
    rj, rpos_j, rbox_j = jreplicate(js, pos, box, factors)
    assert_systems_equal(rs, rj)
    np.testing.assert_array_equal(rpos, rpos_j)
    np.testing.assert_array_equal(rbox, rbox_j)


def test_replicate_energies_scale():
    """tests/test_replicate.py's check on the port: the (1, 2, 2) replica
    carries 4x every term (coul_recip within 5e-3 of max(|E|, 1), the
    others rtol 2e-4) and copy 0 the original's forces (rtol 2e-3, atol
    2e-2), both on the dense sweep."""
    js, pos, box = _charged_fluid()
    ps = system_from_numpy(js)

    def evaluate(system, p, b):
        ev = TFE(system, pair_kernel="dense", device="cpu")
        terms, f = ev.energy_forces(torch.as_tensor(np.asarray(p,
                                                               np.float32)),
                                    torch.as_tensor(np.asarray(b,
                                                               np.float32)))
        return {k: float(v) for k, v in terms.items()}, f.numpy()
    e1, f1 = evaluate(ps, pos, box)
    rs, rpos, rbox = treplicate(ps, pos, box, (1, 2, 2))
    e4, f4 = evaluate(rs, rpos, rbox)
    for k in e1:
        if k == "coul_recip":
            assert abs(e4[k] - 4 * e1[k]) < 5e-3 * max(abs(e1[k]), 1.0), k
        else:
            np.testing.assert_allclose(e4[k], 4 * e1[k], rtol=2e-4,
                                       err_msg=k)
    np.testing.assert_allclose(f4[:ps.n_atoms], f1, rtol=2e-3, atol=2e-2)


def test_replicate_charmm_fixture_matches_jax(tmp_path):
    """The NBTHOLE / CMAP fixture replicated (2, 1, 2) by both: the CMAP
    terms and NBTHOLE types tiled as the JAX replicate tiles them; a GB
    system refuses to replicate in both."""
    psf_p, prm_p, gro_p = chip_smoke.write_charmm_fixture(str(tmp_path), 2)
    gro = TGro(gro_p)
    create = dict(nonbondedCutoff=1.0, constraints=None, rigidWater=False)
    mine, ref = _load_both(psf_p, prm_p, gro.box, **create)
    rs, rpos, rbox = treplicate(mine.system, gro.positions, gro.box,
                                (2, 1, 2))
    rj, rpos_j, rbox_j = jreplicate(ref.system, gro.positions, gro.box,
                                    (2, 1, 2))
    assert_systems_equal(rs, rj)
    np.testing.assert_array_equal(rpos, rpos_j)
    assert rs.cmap_atoms.shape == (32, 8)
    gb_mine, gb_ref = _load_both(psf_p, prm_p, gro.box, use_pme=False,
                                 implicitSolvent="OBC2", **create)
    for fn, built in ((treplicate, gb_mine), (jreplicate, gb_ref)):
        with pytest.raises(NotImplementedError):
            fn(built.system, gro.positions, gro.box, (1, 1, 2))


@pytest.mark.parametrize("variant", ["pme", "gb"])
def test_loaded_fixture_context_tracks_jax(tmp_path, variant):
    """The slice as a whole: chip_smoke's NBTHOLE / CMAP fixture (8 cells,
    72 atoms) loaded by each package's loaders and stepped 10 times in
    the middle scheme by each package's Context, on recip="pme" (the port
    on its dense sweep, as the JAX package is on the CPU) or with GB
    (OBC2, salt, ACE; no Ewald): positions within 2e-4 nm a step and terms
    and kinetic energy at tests/test_torch_slice.py's dense-path
    tolerances."""
    import jax.numpy as jnp

    import openmm_velocityverlet_tpu as jpkg
    import openmm_velocityverlet_tpu_torch as tpkg
    psf_p, prm_p, gro_p = chip_smoke.write_charmm_fixture(str(tmp_path), 2)
    gro = TGro(gro_p)
    create = dict(nonbondedCutoff=0.7, constraints=None, rigidWater=False)
    if variant == "gb":
        create.update(use_pme=False, implicitSolvent="OBC2",
                      implicitSolventSaltConc=0.15, gbsaModel="ACE")
    mine, ref = _load_both(psf_p, prm_p, gro.box, **create)
    # the JAX Context traces cmap_energy, whose host numpy coefficient
    # tables cannot be indexed by traced cell indices: hand it device
    # arrays (the JAX package's own CMAP tests evaluate eagerly)
    js = ref.system.replace(**{k: jnp.asarray(getattr(ref.system, k))
                               for k in ("cmap_map", "cmap_coeffs",
                                         "cmap_res")})
    rng = np.random.default_rng(8)
    vel = (rng.normal(0, 0.3, gro.positions.shape)
           * (np.asarray(ref.system.masses) > 0.5)[:, None])
    runs = {}
    for pkg, system in ((jpkg, js), (tpkg, mine.system)):
        integ = pkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
        integ.setMaxDrudeDistance(0.02)
        kw = dict(device="cpu", pair_kernel="dense") if pkg is tpkg else {}
        ctx = pkg.Context(system, integ, positions=gro.positions,
                          box=gro.box, recip="pme", **kw)
        ctx.set_velocities(vel)
        traj = []
        for _ in range(10):
            ctx.step(1)
            traj.append(np.asarray(ctx.get_positions(), np.float64))
        runs[pkg] = (np.stack(traj), ctx.potential_energy_terms(),
                     ctx.kinetic_energy())
    (tj, ej, kj), (tt, et, kt) = runs[jpkg], runs[tpkg]
    assert {"nbthole", "cmap"} <= set(et) and ("gb" in et) == (
        variant == "gb")
    drift = np.abs(tt - tj).max(axis=(1, 2))
    print(f"\n[{variant}] max |dpos| per step (nm): "
          + " ".join(f"{d:.2e}" for d in drift))
    assert drift.max() < 2e-4
    assert set(et) == set(ej)
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, atol=0.5,
                                   err_msg=k)
    np.testing.assert_allclose(kt, kj, rtol=1e-3)
