"""The multi-device mesh (parallel/mesh.py, pair_tri.banded_sweep_sharded,
ForceEvaluator / Context / app on a mesh) on the CPU: ranks are processes
spawned with torch.multiprocessing over gloo and a file store under
tmp_path; each rank writes its arrays there and the test process compares
them with the port's unsharded runs and with the JAX package's mesh (on
the 8 virtual CPU devices of tests/conftest.py).  Tolerances are those of
tests/test_multichip.py (named at each case); the ranks themselves must
end bitwise equal.  One spawn per world size runs every case of that size.
The card case (one rank under NCCL, two ranks sharing the card under gloo)
is marked ``cuda`` and skips here."""
import functools
import os
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu_torch.app import (DCDReporter,
                                                 DrudeTemperatureReporter,
                                                 GroReporter, Simulation,
                                                 StateDataReporter,
                                                 load_checkpoint,
                                                 save_checkpoint)
from openmm_velocityverlet_tpu_torch.models.drude_water import drude_water_box
from openmm_velocityverlet_tpu_torch.ops import allpairs, pair_tri
from openmm_velocityverlet_tpu_torch.parallel.mesh import (Mesh,
                                                           carry_shardings,
                                                           launched_mesh,
                                                           make_mesh)

BETA, RC, TS, BAND_W = 2.2, 1.2, 128, 3
SWEEP_SYSTEMS = ((512, 9), (514, 11))   # 2048 atoms; 2056 (17 tiles)


@pytest.fixture(autouse=True)
def _one_thread():
    """The unsharded runs here on one thread, as each rank runs: on a host
    shared with other test workers, torch's default of a thread a core
    turns these small systems' many ops into waits (100 steps of the LJ
    fluid took 444 s so, 1.6 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the systems
def _lj_fluid(n_side, spacing=0.4):
    """__graft_entry__._small_system's charged LJ fluid (Ewald, NH) built
    by the port's builder."""
    b = tpkg.SystemBuilder()
    for i in range(n_side ** 3):
        b.add_particle(39.948, charge=0.1 if i % 2 == 0 else -0.1, lj_type=0)
    b.set_lj_from_type_params([0.34], [0.996])
    box = np.array([n_side * spacing] * 3)
    pos = np.stack(np.meshgrid(*[np.arange(n_side) * spacing + spacing / 2]
                               * 3, indexing="ij"), -1).reshape(-1, 3)
    system = b.finalize(box, r_cutoff=min(0.7, box[0] / 2 * 0.9),
                        use_pme=True)
    return system, pos, box


def _velocities(system, pos, temperature, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, pos.shape) * np.sqrt(
        0.0083144626 * temperature * np.asarray(system.inv_masses))[:, None]
        ).astype(np.float32)


def _drude_wired(n_mol):
    """drude_water_box with __graft_entry__._drude_system's wiring: TGNH
    with Drude pairs, constraints and the hard wall, the last quarter of
    the molecules on Langevin, an E-field of 0.5 V/nm on the other cores."""
    integ = tpkg.VVIntegrator(300.0, 10.0, 1.0, 40.0, 0.001)
    integ.setMaxDrudeDistance(0.02)
    n_ld = n_mol // 4
    for m in range(n_mol - n_ld, n_mol):
        for k in range(4):
            integ.addParticleLangevin(4 * m + k)
    for m in range(n_mol - n_ld):
        integ.addParticleElectrolyte(4 * m)
    integ.setElectricField(0.5)
    return integ


def _band_integrator():
    integ = tpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
    integ.setMaxDrudeDistance(0.02)
    return integ


def _jittered_drude(n_mol, seed=3):
    """drude_water_box with tests/test_torch_slice.py's _drude_positions
    (every Drude 0.012 nm from its core)."""
    ps, pos, box = drude_water_box(n_mol)
    rng = np.random.default_rng(seed)
    p = pos + rng.normal(0, 0.01, pos.shape)
    d = rng.normal(size=(pos.shape[0] // 4, 3))
    d *= 0.012 / np.linalg.norm(d, axis=1, keepdims=True)
    p[1::4] = p[0::4] + d
    return ps, p.astype(np.float32), box


def _log_barostat(ctx):
    """The accept flag of every barostat attempt, in order."""
    log, real = [], ctx._barostat_attempt

    def logged():
        log.append(real())
        return log[-1]
    ctx._barostat_attempt = logged
    return log


# ------------------------------------------------------- the runs (shared)
def run_ctx(mesh, device="cpu"):
    """Case 5: the wired Drude water, 1 and 3 steps."""
    ps, pos, box = _jittered_drude(125)
    ctx = tpkg.Context(ps, _drude_wired(125), positions=pos, box=box,
                       pair_ts=32, mesh=mesh, device=device,
                       fold_exc14=mesh is None)
    ctx.set_velocities(_velocities(ps, pos, 300.0, 5))
    out = {}
    for n, tag in ((1, "1"), (2, "3")):
        ctx.step(n)
        out["pos" + tag] = ctx.get_positions()
        out["vel" + tag] = ctx.get_velocities()
        out["eta" + tag] = ctx.state.nh_eta.cpu().numpy()
    return out


def run_band(mesh):
    """Case 6: Langevin-free band route, 10 steps (the port side)."""
    ps, pos, box = _jittered_drude(125)
    ctx = tpkg.Context(ps, _band_integrator(), positions=pos, box=box,
                       fold_exc14=True, pair_ts=32, mesh=mesh, device="cpu")
    ctx.set_velocities(_velocities(ps, pos, 333.0, 5))
    traj = []
    for _ in range(10):
        ctx.step(1)
        traj.append(ctx.get_positions())
    return dict(traj=np.stack(traj), terms=ctx.potential_energy_terms(),
                ke=ctx.kinetic_energy(), pair_ts=ctx.evaluator.pairs.ts,
                band_w=ctx.evaluator.pairs.band_w)


def run_lj100(mesh):
    """Case 7: 100 steps of the charged LJ fluid (512 atoms)."""
    ps, pos, box = _lj_fluid(8)
    ctx = tpkg.Context(ps, tpkg.VVIntegrator(temperature=120.0,
                                             frequency=10.0,
                                             step_size=0.002),
                       positions=pos, box=box, pair_ts=32, mesh=mesh,
                       fold_exc14=mesh is None, device="cpu")
    ctx.set_velocities(_velocities(ps, pos, 120.0, 8))
    ctx.step(100)
    return dict(pos=ctx.get_positions(), vel=ctx.get_velocities(),
                rebuilds=ctx.rebuilds)


def run_reporters(mesh, workdir):
    """Case 8: the 729-atom fluid (730 on 2 ranks) with StateData, GRO,
    DCD and DrudeTemperature reporters and a checkpoint round trip, in
    ``workdir``."""
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        ps, pos, box = _lj_fluid(9)
        ctx = tpkg.Context(ps, tpkg.VVIntegrator(temperature=120.0,
                                                 frequency=10.0,
                                                 step_size=0.002),
                           positions=pos, box=box, pair_ts=32, mesh=mesh,
                           fold_exc14=mesh is None, device="cpu")
        ctx.set_velocities(_velocities(ps, pos, 120.0, 9))

        class Topo:
            n_atoms = 729
            atom_names = ["X"] * 729
            residue_ids = [1] * 729
            residue_names = ["MOL"] * 729

        sim = Simulation(Topo(), ctx)
        sim.reporters += [
            StateDataReporter("state.txt", 2, elapsed_time=False),
            GroReporter("dump.gro", 4), DCDReporter("dump.dcd", 2),
            DrudeTemperatureReporter("T_drude.txt", 4)]
        sim.step(8)
        for r in sim.reporters:
            r.close()
        save_checkpoint(ctx, "c.cpt")
        before = ctx.get_positions()
        ctx.step(3)
        load_checkpoint(ctx, "c.cpt")
        restored = ctx.get_positions()
        ctx.step(2)
        return dict(n_atoms=ctx.system.n_atoms, n_real=ctx.n_real,
                    shapes=(before.shape, ctx.get_velocities().shape),
                    restored=bool(np.array_equal(restored, before)),
                    after=ctx.get_positions(), ke=ctx.kinetic_energy())
    finally:
        os.chdir(cwd)


def run_npt(mesh):
    """Case 9: iso barostat every 2 steps, 12 steps."""
    ps, pos, box = _jittered_drude(125)
    ctx = tpkg.Context(ps, _band_integrator(), positions=pos, box=box,
                       pair_ts=32, fold_exc14=mesh is None, mesh=mesh,
                       barostat=tpkg.BarostatConfig("iso", 1.0, 333.0, 2),
                       device="cpu")
    ctx.set_velocities(_velocities(ps, pos, 333.0, 6))
    log = _log_barostat(ctx)
    ctx.step(12)
    return dict(log=log, box=ctx.get_box(), pos=ctx.get_positions())


def run_image(mesh):
    """Case 10: chip_smoke's 648-atom constant-voltage slab (image pairs,
    E-field, external forces), 5 steps: the mirror route unsharded, the
    explicit sum over all atoms on a mesh."""
    import chip_smoke
    system, pos, box, wire, more = chip_smoke.small_edl()
    integ = _band_integrator()
    wire(integ, 64)
    ctx = tpkg.Context(system, integ, positions=pos, box=box, pair_ts=32,
                       fold_exc14=mesh is None, mesh=mesh, device="cpu",
                       **more)
    rng = np.random.default_rng(7)
    ctx.set_velocities(rng.normal(0.0, 0.3, pos.shape)
                       * (np.asarray(system.masses) > 0.5)[:, None])
    ctx.step(5)
    return dict(pos=ctx.get_positions(), mirror=ctx.image_mirror,
                terms=ctx.potential_energy_terms())


def run_sweeps(mesh, inputs):
    """Cases 3-4: banded_sweep_sharded on the _mol_system inputs."""
    out = []
    for pos, box, q, tables in inputs:
        r = pair_tri.banded_sweep_sharded(
            mesh, torch.as_tensor(pos), torch.as_tensor(box),
            torch.as_tensor(q), tables, BETA, RC, TS, BAND_W)
        out.append([float(e) for e in r[:5]] + [r[5].numpy()])
    return out


def run_cli(workdir):
    """Case 11: run_bulk.gen_simulation(mesh_devices=1) on a world of one
    (the 1,125-atom CHARMM fixture, 2 steps)."""
    import chip_smoke
    from openmm_velocityverlet_tpu_torch.examples import run_bulk
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        psf, prm, gro = chip_smoke.write_charmm_fixture(workdir, 5)
        sim = run_bulk.gen_simulation(gro, psf, prm, T=333,
                                      tcoupl="nose-hoover", pcoupl="no",
                                      mesh_devices=1, device="cpu")
        ctx = sim.context
        ctx.step(2)
        return dict(size=ctx.mesh.size, backend=ctx.mesh.backend,
                    pos=ctx.get_positions(), mode=ctx.evaluator.pairs.mode)
    finally:
        os.chdir(cwd)


def _rank_main(rank, size, store, out, cases, inputs):
    torch.set_num_threads(1)
    mesh = make_mesh(size=size, device="cpu", init_method=store, rank=rank)
    assert (mesh.rank, mesh.size, mesh.backend) == (rank, size, "gloo")
    res = {}
    for case in cases:
        if case == "sweeps":
            res[case] = run_sweeps(mesh, inputs["sweeps"])
        elif case == "reporters":
            res[case] = run_reporters(mesh, os.path.join(out, "mesh_rep"))
        elif case == "cli":
            res[case] = run_cli(os.path.join(out, "cli"))
        else:
            res[case] = globals()["run_" + case](mesh)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    torch.distributed.destroy_process_group()


def _spawn(out, size, cases, inputs=None):
    """Run ``cases`` on ``size`` ranks; returns each rank's results."""
    os.makedirs(out, exist_ok=True)
    mp.start_processes(_rank_main, args=(size, f"file://{out}/store", out,
                                         cases, inputs or {}),
                       nprocs=size, start_method="spawn")
    res = []
    for r in range(size):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


@functools.lru_cache(maxsize=1)
def _sweep_inputs():
    from tests.test_pallas import _mol_system
    out = []
    for n_mol, seed in SWEEP_SYSTEMS:
        lj_type, a, b, excl, pos, box, q = _mol_system(
            n_mol, np.random.default_rng(seed), lz=16.0)
        tables = allpairs.build_pair_tables(len(lj_type), lj_type, a, b,
                                            excl)
        assert tables["residual"].shape[0] == 0
        out.append((pos.astype(np.float32), box.astype(np.float32),
                    q.astype(np.float32), tables))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh2"))
    return _spawn(out, 2, ["sweeps", "ctx", "band", "lj100", "reporters",
                           "npt", "image"], {"sweeps": _sweep_inputs()}), out


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh3"))
    return _spawn(out, 3, ["sweeps"], {"sweeps": _sweep_inputs()})


def _same_on_every_rank(ranks, case, key):
    first = ranks[0][case][key]
    for r in ranks[1:]:
        assert np.array_equal(r[case][key], first), (case, key)
    return first


# ----------------------------------------------------------------- cases
def test_pad_system_matches_jax():
    """Case 1: table by table against the JAX pad_system on
    __graft_entry__._drude_system(n_mol=13): 52 atoms padded to 54."""
    import __graft_entry__ as ge
    from openmm_velocityverlet_tpu.system import pad_system as jpad
    from openmm_velocityverlet_tpu_torch.system import (pad_system,
                                                        system_from_numpy)
    js = ge._drude_system(n_mol=13).system
    assert js.n_atoms == 52
    mine = pad_system(system_from_numpy(js), 54)
    ref = jpad(js, 54)
    assert mine.n_atoms == ref.n_atoms == 54
    for f in mine.__dataclass_fields__:
        a, b = getattr(mine, f), getattr(ref, f)
        if f == "gb":
            assert a is None and b is None
        elif isinstance(a, (int, float, tuple)):
            assert a == (tuple(int(k) for k in b) if f == "kmax" else b), f
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
    assert pad_system(mine, 54) is mine


def test_carry_shardings_layout():
    """Case 2: per-atom leaves on "atoms", the rest replicated
    (tests/test_multichip.py:140-150)."""
    ps, pos, box = drude_water_box(16)
    st = tpkg.make_state(pos, box, device="cpu")
    mesh = Mesh(group=None, rank=0, size=8, device=torch.device("cpu"),
                backend="gloo")
    sh = carry_shardings(st, mesh, n_atoms=ps.n_atoms)
    assert sh.pos == sh.pos_err == sh.vel == "atoms"
    assert sh.nh_eta is None and sh.box is None and sh.generator is None
    assert sh.step is None and sh.time is None
    assert carry_shardings(st, mesh).pos == "atoms"


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("which", [0, 1])
def test_banded_sweep_sharded(size, which, two_ranks, three_ranks):
    """Case 3: each rank's summed result against the port's unsharded
    direct_space_band (energies rtol 1e-6, forces rtol 1e-6 / atol 1e-4)
    and the dense sweep (forces rtol 1e-3 / atol 5e-2, energies rtol 2e-4:
    tests/test_multichip.py:101-109, 257-260), on 2048 atoms and on 2056
    (17 tiles, which neither 2 nor 3 ranks divide)."""
    ranks = two_ranks[0] if size == 2 else three_ranks
    pos, box, q, tables = _sweep_inputs()[which]
    outs = [r["sweeps"][which] for r in ranks]
    for o in outs[1:]:
        assert all(np.array_equal(x, y) for x, y in zip(o, outs[0]))
    out = outs[0]
    pt, bt, qt = (torch.as_tensor(x) for x in (pos, box, q))
    ref = pair_tri.direct_space_band(pt, bt, qt, tables, BETA, RC, TS,
                                     BAND_W)
    assert not bool(ref[6])
    for k in range(5):
        np.testing.assert_allclose(out[k], float(ref[k]), rtol=1e-6)
    np.testing.assert_allclose(out[5], ref[5].numpy(), rtol=1e-6, atol=1e-4)
    dense = allpairs.direct_space_dense(pt, bt, qt, tables, BETA, RC, 256)
    np.testing.assert_allclose(out[5], dense[5].numpy(), rtol=1e-3,
                               atol=5e-2)
    for k in (0, 1, 2):
        np.testing.assert_allclose(out[k], float(dense[k]), rtol=2e-4)


@pytest.mark.parametrize("size", [2, 3])
def test_banded_sweep_sharded_matches_jax(size, two_ranks, three_ranks):
    """Case 4: the JAX banded_sweep_sharded (its B2 in interpret mode) on
    as many virtual devices, same inputs: forces at the dense bound
    (rtol 1e-3 / atol 5e-2) and energies at rtol 2e-4, as the two packages'
    kernels differ in summation order."""
    import jax
    import jax.numpy as jnp
    from openmm_velocityverlet_tpu.ops import allpairs as jap
    from openmm_velocityverlet_tpu.ops import pallas_pair
    from openmm_velocityverlet_tpu.parallel.mesh import make_mesh as jmesh
    from tests.test_pallas import _mol_system
    ranks = two_ranks[0] if size == 2 else three_ranks
    mesh = jmesh(jax.devices()[:size])
    for which, (n_mol, seed) in enumerate(SWEEP_SYSTEMS):
        lj_type, a, b, excl, pos, box, q = _mol_system(
            n_mol, np.random.default_rng(seed), lz=16.0)
        tables = jap.build_pair_tables(len(lj_type), lj_type, a, b, excl)
        ref = pallas_pair.banded_sweep_sharded(
            mesh, "atoms", jnp.asarray(pos, jnp.float32), box,
            jnp.asarray(q, jnp.float32), tables, BETA, RC, TS, BAND_W,
            interpret=True)
        out = ranks[0]["sweeps"][which]
        np.testing.assert_allclose(out[5], np.asarray(ref[5]), rtol=1e-3,
                                   atol=5e-2)
        for k in range(5):
            np.testing.assert_allclose(out[k], float(ref[k]), rtol=2e-4)


def test_context_mesh_matches_unsharded(two_ranks):
    """Case 5: the wired Drude water (TGNH, Drude, constraints, Langevin
    quarter, E-field) on 2 ranks against the unsharded Context: positions
    within 1e-6 nm after one step and 1e-5 after three, velocities 1e-5 /
    1e-3, NH chains 1e-5 (tests/test_multichip.py:58-68)."""
    ranks = two_ranks[0]
    for key in ("pos3", "vel3", "eta3"):
        _same_on_every_rank(ranks, "ctx", key)
    out, ref = ranks[0]["ctx"], run_ctx(None)
    np.testing.assert_allclose(out["pos1"], ref["pos1"], atol=1e-6)
    np.testing.assert_allclose(out["vel1"], ref["vel1"], atol=1e-5)
    np.testing.assert_allclose(out["pos3"], ref["pos3"], atol=1e-5)
    np.testing.assert_allclose(out["vel3"], ref["vel3"], atol=1e-3)
    np.testing.assert_allclose(out["eta3"], ref["eta3"], atol=1e-5)


def test_context_mesh_tracks_jax_mesh(two_ranks):
    """Case 6: against the JAX Context on a 2-device mesh whose evaluator
    runs the JAX row-sharded kernel (pair_kernel="pallas", interpret
    mode), Langevin-free drude_water_box(125), fold_exc14, 32-atom tiles,
    10 steps: max |dpos| < 2e-5 nm per step, terms within 1e-3 relative /
    0.5 kJ/mol, kinetic energy within 1e-3 (tests/test_torch_slice.py:
    176-215)."""
    import jax
    import openmm_velocityverlet_tpu as jpkg
    from openmm_velocityverlet_tpu.forces import ForceEvaluator as JFE
    from openmm_velocityverlet_tpu.parallel.mesh import make_mesh as jmesh
    ranks = two_ranks[0]
    _same_on_every_rank(ranks, "band", "traj")
    out = ranks[0]["band"]
    js, pos, box = drude_water_box(125, None, jpkg.SystemBuilder)
    _, pos, _ = _jittered_drude(125)
    mesh = jmesh(jax.devices()[:2])
    integ = jpkg.VVIntegrator(333.0, 10.0, 1.0, 40.0, 0.001)
    integ.setMaxDrudeDistance(0.02)
    opts = dict(recip="exact", fold_exc14=True, pair_ts=32)
    ctx = jpkg.Context(js, integ, positions=pos, box=box, mesh=mesh, **opts)
    ctx.evaluator = JFE(js, pair_kernel="pallas", pallas_interpret=True,
                        box_hint=box, pos_hint=pos, mesh=mesh, **opts)
    assert (ctx.evaluator.pair_mode, ctx.evaluator.pair_ts,
            ctx.evaluator.band_w) == ("band", out["pair_ts"], out["band_w"])
    ctx.set_velocities(_velocities(js, pos, 333.0, 5))
    traj = []
    for _ in range(10):
        ctx.step(1)
        traj.append(np.asarray(ctx.get_positions(), np.float64))
    drift = np.abs(out["traj"] - np.stack(traj)).max(axis=(1, 2))
    print("\n[mesh band] max |dpos| per step (nm): "
          + " ".join(f"{d:.2e}" for d in drift))
    assert drift.max() < 2e-5
    terms = ctx.potential_energy_terms()
    for k in terms:
        np.testing.assert_allclose(out["terms"][k], terms[k], rtol=1e-3,
                                   atol=0.5, err_msg=k)
    np.testing.assert_allclose(out["ke"], ctx.kinetic_energy(), rtol=1e-3)


def test_lj_fluid_100_steps(two_ranks):
    """Case 7: 100 steps of the charged LJ fluid on 2 ranks against the
    unsharded run: positions rtol 1e-4 / atol 2e-4, velocities rtol 1e-3 /
    atol 2e-3 (tests/test_multichip.py:112-137)."""
    ranks = two_ranks[0]
    _same_on_every_rank(ranks, "lj100", "pos")
    _same_on_every_rank(ranks, "lj100", "vel")
    out, ref = ranks[0]["lj100"], run_lj100(None)
    assert out["rebuilds"] == ref["rebuilds"]
    np.testing.assert_allclose(out["pos"], ref["pos"], rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(out["vel"], ref["vel"], rtol=1e-3, atol=2e-3)


def test_padded_mesh_reporters_and_checkpoint(two_ranks, tmp_path):
    """Case 8 (tests/test_multichip.py:204-245): 729 atoms padded to 730;
    the reporters see 729, only rank 0 writes (one set of files), and the
    files equal the unsharded run's: GRO and DrudeTemperature bytes, the
    DCD's header bytes and its frames within 1e-4 nm, the StateData rows
    but for the speed column.  The checkpoint restores bitwise and the
    run steps on from it."""
    ranks, out_dir = two_ranks
    for r in ranks:
        out = r["reporters"]
        assert (out["n_atoms"], out["n_real"]) == (730, 729)
        assert out["shapes"] == ((729, 3), (729, 3)) and out["restored"]
        assert np.isfinite(out["ke"])
    _same_on_every_rank(ranks, "reporters", "after")
    mesh_dir = os.path.join(out_dir, "mesh_rep")
    assert sorted(os.listdir(mesh_dir)) == ["T_drude.txt", "c.cpt",
                                            "dump.dcd", "dump.gro",
                                            "state.txt"]
    run_reporters(None, str(tmp_path))

    def read(d, name):
        with open(os.path.join(d, name), "rb") as fh:
            return fh.read()
    for name in ("dump.gro", "T_drude.txt"):
        assert read(mesh_dir, name) == read(str(tmp_path), name), name
    a, b = read(mesh_dir, "dump.dcd"), read(str(tmp_path), "dump.dcd")
    assert len(a) == len(b) and a[:196] == b[:196]
    np.testing.assert_allclose(np.frombuffer(a[196:], "<f4"),
                               np.frombuffer(b[196:], "<f4"), atol=1e-3)

    def rows(d):
        return [line.split("\t")[:-1] for line in
                read(d, "state.txt").decode().splitlines()]
    assert rows(mesh_dir) == rows(str(tmp_path))


def test_npt_acceptances(two_ranks):
    """Case 9: the barostat (every 2 steps) accepts and rejects alike on
    every rank and as the unsharded run does; box and positions follow."""
    ranks = two_ranks[0]
    log = _same_on_every_rank(ranks, "npt", "log")
    _same_on_every_rank(ranks, "npt", "box")
    ref = run_npt(None)
    assert len(log) == 6 and log == ref["log"]
    np.testing.assert_allclose(ranks[0]["npt"]["box"], ref["box"],
                               rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["npt"]["pos"], ref["pos"],
                               atol=1e-4)


def test_image_pairs_take_the_explicit_sum(two_ranks):
    """Case 10: on a mesh the image-pair system takes the explicit
    reciprocal over all atoms; it tracks the unsharded mirror route over
    5 steps within 1e-4 nm, terms within 1e-3 relative / 0.5 kJ/mol."""
    ranks = two_ranks[0]
    _same_on_every_rank(ranks, "image", "pos")
    out, ref = ranks[0]["image"], run_image(None)
    assert out["mirror"] is None and ref["mirror"] is not None
    np.testing.assert_allclose(out["pos"], ref["pos"], atol=1e-4)
    for k, v in ref["terms"].items():
        np.testing.assert_allclose(out["terms"][k], v, rtol=1e-3, atol=0.5,
                                   err_msg=k)


def test_run_bulk_mesh_of_one(tmp_path):
    """Case 11: run_bulk.gen_simulation(mesh_devices=1) on a world of one
    builds a band mesh Context and steps."""
    (res,) = _spawn(str(tmp_path), 1, ["cli"])
    out = res["cli"]
    assert (out["size"], out["backend"], out["mode"]) == (1, "gloo", "band")
    assert out["pos"].shape == (1125, 3) and np.isfinite(out["pos"]).all()


def test_mesh_flag_needs_its_ranks(monkeypatch):
    """Case 12: --mesh N under a launch of another number of ranks raises a
    ValueError that names torchrun, before any process group starts."""
    from openmm_velocityverlet_tpu_torch.examples import run_bulk
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 3"):
        launched_mesh(3, "cpu")
    monkeypatch.delenv("WORLD_SIZE")
    args = run_bulk.parser.parse_args(["--mesh", "2"])
    assert args.mesh == 2
    with pytest.raises(ValueError, match="torchrun"):
        launched_mesh(args.mesh, "cpu")
    assert not torch.distributed.is_initialized()


def _card_rank(rank, size, store, out, backend):
    mesh = make_mesh(size=size, device="cuda:0", backend=backend,
                     init_method=store, rank=rank)
    res = run_ctx(mesh, device="cuda")
    with open(os.path.join(out, f"card{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("size,backend", [(1, "nccl"), (2, "gloo")])
def test_mesh_on_the_card(size, backend, tmp_path):
    """The wired Drude water on the card: one rank under NCCL and two
    ranks sharing the card under gloo (NCCL refuses two ranks on one
    device), against the unsharded card run at case 5's tolerances; the
    split sweep launches kernel B2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B2 has no CPU mode")
    out = str(tmp_path)
    mp.start_processes(_card_rank, args=(size, f"file://{out}/store", out,
                                         backend),
                       nprocs=size, start_method="spawn")
    res = []
    for r in range(size):
        with open(os.path.join(out, f"card{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    for r in res[1:]:
        assert np.array_equal(r["pos3"], res[0]["pos3"])
    ref = run_ctx(None, device="cuda")
    np.testing.assert_allclose(res[0]["pos1"], ref["pos1"], atol=1e-6)
    np.testing.assert_allclose(res[0]["pos3"], ref["pos3"], atol=1e-5)
