"""The port's application layer (openmm_velocityverlet_tpu_torch/app.py)
against the JAX package's app.py: DCD bytes, GRO frames, the StateData,
DrudeTemperature and Viscosity columns, checkpoints (the port's own round
trip and a JAX checkpoint loaded into the port), the L-BFGS minimizer on
tests/test_smoke.py's perturbed LJ fluid, and Simulation.step's report
schedule."""
import math
import struct
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu import app as japp
from openmm_velocityverlet_tpu.native import get_lib
from openmm_velocityverlet_tpu_torch import app as tapp
from openmm_velocityverlet_tpu_torch.models.drude_water import drude_water_box
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from tests.test_smoke import make_lj_fluid

# the DCD header's 80-byte title record, the one place the two files differ
TITLE = slice(100, 180)


class _StubContext:
    """What the reporters read from a context, from arrays the test sets:
    the same numbers for both packages' reporters."""

    def __init__(self, system=None, n=5, dt=0.002, seed=0):
        self.system = system
        self.mesh = None
        self.integrator = SimpleNamespace(getStepSize=lambda: dt,
                                          getCosAcceleration=lambda: 0.02)
        self.rng = np.random.default_rng(seed)
        self.current_step = 0
        self.time = 0.0
        self.dt = dt
        self.chunks = []
        self.n = n if system is None else system.n_atoms
        self.move()

    def move(self):
        # positions in [0, 10) nm: many of them meet the float32 rounding
        # of the DCD path (the JAX reporter scales by 10, divides by 10,
        # and its C encoder scales by 10 again)
        self.pos = self.rng.uniform(0.0, 10.0, (self.n, 3)).astype(np.float32)
        self.vel = self.rng.normal(0.0, 0.5, (self.n, 3)).astype(np.float32)
        self.box = self.rng.uniform(9.0, 11.0, 3).astype(np.float32)
        self.epot = float(self.rng.uniform(-5e4, -1e4))
        self.ekin = float(self.rng.uniform(1e3, 5e3))

    def step(self, n):
        self.chunks.append(n)
        self.current_step += n
        self.time += n * self.dt
        self.move()

    def get_positions(self):
        return self.pos.copy()

    def get_velocities(self):
        return self.vel.copy()

    def get_box(self):
        return self.box.copy()

    def potential_energy(self):
        return self.epot

    def kinetic_energy(self):
        return self.ekin

    def get_viscosity(self):
        return 0.0123, 4567.8


def _topology(n):
    return SimpleNamespace(atom_names=[f"C{i % 3}" for i in range(n)],
                           residue_names=["RES" if i < n // 2 else "IMG"
                                          for i in range(n)],
                           residue_ids=[1 + i // 4 for i in range(n)])


def _drive(app, reporters_of, chunks, **ctx_kw):
    """Both packages' Simulation over identical stub contexts (same seed):
    returns (the context, the reporters)."""
    ctx = _StubContext(**ctx_kw)
    sim = app.Simulation(_topology(ctx.n), ctx)
    sim.reporters.extend(reporters_of(app))
    for n in chunks:
        sim.step(n)
    sim.flush()
    return ctx, sim.reporters


def test_dcd_bytes_equal_jax(tmp_path):
    """DCD frames of the same positions and boxes, through both packages'
    DCDReporter (background writer), then 2 more frames appended by new
    reporters in append mode: the files are byte-equal apart from the
    title record.  The JAX reporter runs its C encoder here."""
    assert get_lib() is not None, "the JAX package's C encoder did not build"
    files = {}
    for app in (japp, tapp):
        path = str(tmp_path / f"{app.__name__}.dcd")
        for append, chunks in ((False, [7, 3, 10, 10]), (True, [5, 5, 10])):
            rep = app.DCDReporter(path, 5, append=append)
            ctx = _StubContext(n=37)
            sim = app.Simulation(None, ctx)
            sim.reporters.append(rep)
            for n in chunks:
                sim.step(n)
            rep.close()
        files[app] = open(path, "rb").read()
    mine, ref = files[tapp], files[japp]
    assert struct.unpack("<i", mine[8:12])[0] == 6 + 4
    assert len(mine) == len(ref) == 196 + 10 * (56 + 3 * (8 + 4 * 37))
    assert mine[TITLE].startswith(b"Created by openmm_velocityverlet_tpu_torch")
    assert mine[:TITLE.start] == ref[:TITLE.start]
    assert mine[TITLE.stop:] == ref[TITLE.stop:]
    # the JAX reporter's float32 path, x * 10 / 10 * 10.0f, is one scaling
    # by 10 on every mantissa (scaling by a power of 2 is exact, so [1, 2)
    # covers every normal float32): the port's encoder scales once
    x = np.arange(0x3F800000, 0x40000000, dtype=np.uint32).view(np.float32)
    ten = np.float32(10.0)
    np.testing.assert_array_equal(x * ten / ten * ten, x * ten)


def test_gro_frames_equal_jax(tmp_path):
    """GroReporter with logarithmic spacing, a subset and velocities, and a
    plain one: the same frames at the same steps as the JAX reporter's,
    apart from each frame's title line (which names the package)."""
    n = 12
    subset = list(range(2, 10))
    out = {}
    for app in (japp, tapp):
        paths = [str(tmp_path / f"{app.__name__}_{k}.gro") for k in range(2)]

        def reporters(app, paths=paths):
            return [app.GroReporter(paths[0], 10, logarithm=True,
                                    subset=subset, report_velocity=True),
                    app.GroReporter(paths[1], 7)]
        _, reps = _drive(app, reporters, [3, 40, 57, 150], n=n)
        for r in reps:
            r._out.close()
        out[app] = [open(p).read().splitlines() for p in paths]
    for mine, ref in zip(out[tapp], out[japp]):
        titles = [i for i, line in enumerate(ref) if line.startswith(
            "written by openmm_velocityverlet_tpu t =")]
        assert len(titles) > 2 and len(mine) == len(ref)
        for i, (a, b) in enumerate(zip(mine, ref)):
            if i in titles:
                assert a == b.replace("openmm_velocityverlet_tpu ",
                                      "openmm_velocityverlet_tpu_torch ")
            else:
                assert a == b
    # log spacing: steps 10, 20, ..., 100, 200 (base 10 below 100)
    steps = [float(line.split("t =")[1].split()[0]) / 0.002
             for line in out[tapp][0] if line.startswith("written")]
    np.testing.assert_allclose(steps, [10, 20, 30, 40, 50, 60, 70, 80, 90,
                                       100, 200])
    assert int(out[tapp][0][1]) == len(subset)


@pytest.mark.parametrize("opts", [
    dict(volume=True, box=False),
    dict(progress=True, remaining_time=True, total_steps=200, cvs=[
        lambda ctx: ctx.current_step * 0.5])])
def test_state_data_columns_equal_jax(opts):
    """StateDataReporter on the same energies, box and _drude_system
    tables: every column equal to the JAX reporter's as printed, but the
    speed and time-remaining columns, which read the wall clock."""
    system, _, _ = drude_water_box(8)
    out = {}
    for app in (japp, tapp):
        buf = []

        class Sink:
            def write(self, s, buf=buf):
                buf.append(s)

        def reporters(app):
            return [app.StateDataReporter(Sink(), 10, elapsed_time=False,
                                          **opts)]
        _drive(app, reporters, [15, 30, 15], system=system)
        out[app] = "".join(buf).splitlines()
    head = out[tapp][0].split("\t")
    assert out[tapp][0] == out[japp][0] and len(out[tapp]) == 7
    clock = [i for i, c in enumerate(head) if c in ('"Speed (ns/day)"',
                                                    '"Time Remaining"')]
    for a, b in zip(out[tapp][1:], out[japp][1:]):
        a, b = a.split("\t"), b.split("\t")
        assert [x for i, x in enumerate(a) if i not in clock] == \
            [x for i, x in enumerate(b) if i not in clock]


def test_state_data_aborts_on_nan():
    system, _, _ = drude_water_box(8)
    ctx = _StubContext(system=system)
    ctx.epot = float("nan")
    rep = tapp.StateDataReporter(SimpleNamespace(write=lambda s: None), 1)
    with pytest.raises(RuntimeError, match="NaN"):
        rep.report(SimpleNamespace(context=ctx, current_step=0))


def test_drude_temperature_and_viscosity_equal_jax():
    """DrudeTemperatureReporter and ViscosityReporter on the same
    velocities of the _drude_system layout (Drude pairs, constraints, the
    CM-motion remover), each package's reporter on its own System: the
    same lines as printed."""
    systems = {japp: drude_water_box(27, None, jpkg.SystemBuilder)[0],
               tapp: drude_water_box(27, None, tpkg.SystemBuilder)[0]}
    out = {}
    for app in (japp, tapp):
        buf = []
        sink = SimpleNamespace(write=buf.append)

        def reporters(app):
            return [app.DrudeTemperatureReporter(sink, 5),
                    app.ViscosityReporter(sink, 10)]
        _drive(app, reporters, [5, 5, 10], system=systems[app])
        out[app] = "".join(buf).splitlines()
    assert len(out[tapp]) == 1 + 4 + 1 + 2
    assert out[tapp] == out[japp]
    t_com, t_atom, t_drude = map(float, out[tapp][1].split("\t")[1:4])
    assert min(t_com, t_atom, t_drude) > 0


def _langevin_context(device="cpu"):
    """The _drude_system wiring on the port (Langevin quarter, E-field,
    TGNH on the rest)."""
    system, pos, box = drude_water_box(16)
    integ = tpkg.VVIntegrator(300.0, 10.0, 1.0, 40.0, 0.001)
    integ.setMaxDrudeDistance(0.02)
    for m in range(12, 16):
        for k in range(4):
            integ.addParticleLangevin(4 * m + k)
    for m in range(12):
        integ.addParticleElectrolyte(4 * m)
    integ.setElectricField(0.5)
    ctx = tpkg.Context(system, integ, positions=pos, box=box, device=device)
    ctx.set_velocities_to_temperature(300.0)
    return ctx


def _state_fields(st):
    return {k: getattr(st, k).clone() for k in tapp._TENSOR_FIELDS}


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """save -> 10 steps -> load: every State field, the generator state,
    step and time equal to the saved ones bit for bit, and the 10 steps
    after the load repeat the 10 steps after the save bitwise (both start
    a fresh pair cache from the same state and draw the same noise)."""
    ctx = _langevin_context()
    ctx.step(15)
    path = str(tmp_path / "cpt")
    tapp.save_checkpoint(ctx, path)
    saved = _state_fields(ctx.state)
    gen = ctx.state.generator.get_state().clone()
    step, t = ctx.state.step, ctx.state.time
    assert float(ctx.state.nh_eta_dot.abs().max()) > 0
    ctx.step(10)
    after = ctx.get_positions()
    vel_after = ctx.get_velocities()
    tapp.load_checkpoint(ctx, path)
    for k, v in saved.items():
        assert torch.equal(getattr(ctx.state, k), v), k
    assert torch.equal(ctx.state.generator.get_state(), gen)
    assert (ctx.state.step, ctx.state.time) == (step, t)
    assert not ctx._forces_valid
    ctx.step(10)
    np.testing.assert_array_equal(ctx.get_positions(), after)
    np.testing.assert_array_equal(ctx.get_velocities(), vel_after)


def test_checkpoint_from_the_card_loads_on_the_cpu(tmp_path):
    """A checkpoint whose generator state is the card's (Philox seed and
    offset, 16 bytes) loads into a CPU Context: every State field bitwise,
    the generator seeded from the saved state's SHA-256, the same on every
    load, and the run steps on."""
    import hashlib
    import pickle
    ctx = _langevin_context()
    ctx.step(5)
    path = str(tmp_path / "cpt")
    tapp.save_checkpoint(ctx, path)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["state"]["generator_device"] == "cpu"
    card_state = np.arange(16, dtype=np.uint8)
    blob["state"].update(generator=card_state, generator_device="cuda")
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    saved = _state_fields(ctx.state)
    want = torch.Generator()
    want.manual_seed(int.from_bytes(
        hashlib.sha256(card_state.tobytes()).digest()[:8], "little"))
    runs = []
    for _ in range(2):
        fresh = _langevin_context()
        tapp.load_checkpoint(fresh, path)
        for k, v in saved.items():
            assert torch.equal(getattr(fresh.state, k), v), k
        assert fresh.current_step == 5
        assert torch.equal(fresh.state.generator.get_state(),
                           want.get_state())
        fresh.step(5)
        runs.append(fresh.get_positions())
    assert np.isfinite(runs[0]).all()
    np.testing.assert_array_equal(runs[0], runs[1])


def test_checkpoint_reporter_keeps_last_three(tmp_path):
    ctx = _langevin_context()
    sim = tapp.Simulation(None, ctx)
    base = str(tmp_path / "cpt.cpt")
    sim.reporters.append(tapp.CheckpointReporter(base, 2))
    sim.step(10)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["cpt.cpt_10", "cpt.cpt_6", "cpt.cpt_8"]
    fresh = _langevin_context()
    sim2 = tapp.Simulation(None, fresh)
    sim2.load_checkpoint(base + "_10")
    assert sim2.currentStep == 10
    np.testing.assert_array_equal(fresh.get_positions(), ctx.get_positions())


def test_jax_checkpoint_loads(tmp_path):
    """A checkpoint written by the JAX package's save_checkpoint: every
    State field equal in the port, the generator seeded from the threefry
    key's two words."""
    jsys, pos, box = drude_water_box(8, None, jpkg.SystemBuilder)
    integ = jpkg.VVIntegrator(300.0, 10.0, 1.0, 40.0, 0.001)
    jctx = jpkg.Context(jsys, integ, positions=pos, box=box)
    rng = np.random.default_rng(3)
    st = jctx.state
    noise = {k: rng.normal(0.0, scale, getattr(st, k).shape)
             for k, scale in (("pos", 0.01), ("pos_err", 1e-8), ("vel", 0.5),
                              ("nh_eta", 1.0), ("nh_eta_dot", 1.0),
                              ("nh_eta_dotdot", 1.0))}
    noise["pos"] += pos
    jctx.state = st.replace(**{
        k: jnp.asarray(v, jnp.float32) for k, v in noise.items()},
        rng_key=jnp.asarray([123, 4567], jnp.uint32),
        step=jnp.asarray(37, jnp.int32), time=jnp.asarray(0.037, jnp.float32),
        cos_v=jnp.asarray(0.25, jnp.float32))
    path = str(tmp_path / "jax.cpt")
    japp.save_checkpoint(jctx, path)
    ctx = tpkg.Context(system_from_numpy(jsys), tpkg.VVIntegrator(),
                       positions=pos, box=box, device="cpu")
    tapp.load_checkpoint(ctx, path)
    for k in tapp._TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(ctx.state, k).numpy(),
                                      np.asarray(getattr(jctx.state, k)),
                                      err_msg=k)
    assert ctx.state.step == 37 and ctx.current_step == 37
    assert ctx.state.time == float(np.float32(0.037))
    assert ctx.state.cos_v == 0.25
    g = torch.Generator()
    g.manual_seed((123 << 32) | 4567)
    assert torch.equal(ctx.state.generator.get_state(), g.get_state())
    ctx.step(2)
    assert np.isfinite(ctx.get_positions()).all()


def _lj_pair(iterations, tolerance=5.0):
    """tests/test_smoke.py:90-107's perturbed LJ fluid minimized by both
    packages: (e0, the JAX energy, the port energy, the port's Context)."""
    system, pos, box = make_lj_fluid(n_side=3)
    rng = np.random.RandomState(2)
    bad = np.asarray(pos) + rng.normal(0, 0.04, (system.n_atoms, 3))
    jctx = jpkg.Context(system, jpkg.VVIntegrator(120.0, 5.0, 1.0, 20.0,
                                                  0.001),
                        positions=bad, box=box)
    ctx = tpkg.Context(system_from_numpy(system),
                       tpkg.VVIntegrator(120.0, 5.0, 1.0, 20.0, 0.001),
                       positions=bad, box=box, device="cpu")
    e0 = ctx.potential_energy()
    ej = japp.Simulation(None, jctx).minimize_energy(
        tolerance=tolerance, max_iterations=iterations)
    sim = tapp.Simulation(None, ctx)
    et = sim.minimize_energy(tolerance=tolerance, max_iterations=iterations)
    return e0, ej, et, ctx, sim


def test_minimizer_meets_smoke_criteria():
    """tests/test_smoke.py:90-107's criteria on the port: the energy falls
    by more than half of |E0| and the RMS force ends under 50 kJ/mol/nm."""
    e0, ej, e_min, ctx, sim = _lj_pair(200)
    assert e_min < e0 - 0.5 * abs(e0), (e0, e_min)
    f = ctx.get_forces()
    rms = float(np.sqrt(np.mean(np.sum(f ** 2, -1))))
    assert rms < 50.0, rms
    assert 0 < sim.minimize_iterations <= 200
    # the JAX run meets them too, at an energy within 1e-4 of the port's
    assert ej < e0 - 0.5 * abs(e0)
    assert abs(e_min - ej) <= 1e-4 * abs(ej)


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_minimizer_first_iterations_track_jax(iterations):
    """The energy after each of the first three L-BFGS iterations equals
    the JAX minimizer's within rtol 1e-5: the same algorithm on float32
    energies that differ in summation order only (the JAX dense sweep, the
    port's plist sweep)."""
    e0, ej, et, _, _ = _lj_pair(iterations)
    assert et < e0
    np.testing.assert_allclose(et, ej, rtol=1e-5)


def test_report_schedule_equals_jax():
    """Simulation.step's chunks and reports for intervals that do not divide
    each other (3, 7, 10 and a logarithmic GRO at 4) equal the JAX
    Simulation's, across step() calls that end off a boundary."""

    class Recorder:
        def __init__(self, interval, log):
            self.interval, self.log = interval, log

        def describeNextReport(self, simulation):
            return self.interval - simulation.current_step % self.interval

        def report(self, simulation):
            self.log.append((self.interval, simulation.current_step))

    runs = {}
    for app in (japp, tapp):
        log = []
        gro = app.GroReporter(SimpleNamespace(write=lambda s: None), 4,
                              logarithm=True)
        ctx, _ = _drive(app, lambda app: [Recorder(3, log), Recorder(7, log),
                                          Recorder(10, log), gro],
                        [25, 1, 44, 30])
        runs[app] = (ctx.chunks, log, ctx.current_step)
    assert runs[tapp] == runs[japp]
    assert runs[tapp][2] == 100 and math.fsum(runs[tapp][0]) == 100
