"""Simulation loop, L-BFGS minimizer, checkpoints and reporters
(counterpart of ``openmm_velocityverlet_tpu/app.py``).

``Simulation.step(n)`` advances the context in chunks to the next reporter
boundary (OpenMM's describeNextReport scheduling); each chunk is one
``Context.step`` call, so each boundary starts a new pair-cache segment, as
it does in the JAX package.  The reporters write the same columns and
files as the JAX package's; the DCD frame encoder is numpy and writes the
bytes the JAX package's C encoder writes.

On a mesh every rank runs the reporters (their energy queries are
collective) but only rank 0 writes files, its own and checkpoints
(``parallel.mesh.writes_files``); ``Simulation.step`` and
``save_checkpoint`` end with a barrier, so what rank 0 wrote is there for
every rank to read.  Every rank reads a checkpoint.
"""
from __future__ import annotations

import hashlib
import math
import os
import pickle
import queue
import struct
import threading
import time
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from .context import Context
from .integrators import stepping
from .parallel.mesh import writes_files
from .system import State, state_from_numpy
from .units import AVOGADRO, BOLTZ


class Simulation:
    def __init__(self, topology, context: Context):
        self.topology = topology
        self.context = context
        self.reporters: List = []
        # iterations of the last minimize_energy call
        self.minimize_iterations = 0

    @property
    def integrator(self):
        return self.context.integrator

    @property
    def current_step(self):
        return self.context.current_step

    # OpenMM-compat alias
    @property
    def currentStep(self):
        return self.context.current_step

    def step(self, n: int):
        remaining = n
        fired = []
        while remaining > 0:
            next_stops = [r.describeNextReport(self) for r in self.reporters]
            chunk = min([remaining] + [s for s in next_stops if s > 0])
            self.context.step(int(chunk))
            remaining -= chunk
            for r, stop in zip(self.reporters, next_stops):
                if stop <= chunk:
                    r.report(self)
                    fired.append(r)
        # drain the background writers that wrote during this call, so
        # their output is on disk when step() returns
        for r in fired:
            flush = getattr(r, "flush", None)
            if flush is not None:
                flush()
        if self.context.mesh is not None:
            self.context.mesh.barrier()

    def flush(self):
        """Join every background writer (a read-after-write barrier for
        callers that read reporter files mid-run)."""
        for r in self.reporters:
            flush = getattr(r, "flush", None)
            if flush is not None:
                flush()

    def save_checkpoint(self, filename):
        save_checkpoint(self.context, filename)

    def load_checkpoint(self, filename):
        load_checkpoint(self.context, filename)

    @torch.no_grad()
    def minimize_energy(self, tolerance=10.0, max_iterations=500,
                        history=10):
        """L-BFGS energy minimization, the JAX package's algorithm: two-loop
        recursion, a 0.05 nm per-component trust region, Armijo
        backtracking, and the steepest-descent direction whenever the
        curvature information is not usable; converged when the RMS force
        is below ``tolerance`` (kJ/mol/nm).  Returns the final energy.

        Energies and forces come through ``Context._energy_query``, so a
        pair list that comes back flagged is repeated on the full list.
        Only massive particles move; image particles are re-placed on their
        parents' mirror before every evaluation.  Each iteration reads a
        few scalars to the host, as the JAX version does."""
        ctx = self.context
        movable = torch.as_tensor(
            np.asarray(ctx.system.inv_masses) > 0, device=ctx.device)[:, None]
        images, mirror = ctx._images, ctx.data.mirror_location

        def place(pos):
            if images is None:
                return pos
            return stepping.update_image_positions(pos, images, mirror)

        def e_and_f(pos, box):
            terms, f = ctx._energy_forces(place(pos), box)
            return float(sum(terms.values())), f * movable

        def dot(a, b):
            return float(torch.sum(a * b))

        pos = ctx.state.pos
        box = ctx.state.box
        e, f = e_and_f(pos, box)
        g = -f                            # gradient
        s_hist, y_hist, rho_hist = [], [], []
        step_cap = 0.05                   # nm, per-component trust region
        self.minimize_iterations = 0
        for _ in range(max_iterations):
            rms = float(torch.sqrt(torch.mean(torch.sum(f * f, -1))))
            if rms < tolerance:
                break
            self.minimize_iterations += 1
            # two-loop recursion
            q = g
            alphas = []
            for s_i, y_i, r_i in zip(reversed(s_hist), reversed(y_hist),
                                     reversed(rho_hist)):
                a_i = r_i * dot(s_i, q)
                alphas.append(a_i)
                q = q - a_i * y_i
            if y_hist:
                y_last = y_hist[-1]
                gamma = float(torch.sum(s_hist[-1] * y_last)
                              / torch.clamp(torch.sum(y_last * y_last),
                                            min=1e-30))
                q = gamma * q
            else:
                q = q * (0.01 / max(rms, 1e-6))
            for (s_i, y_i, r_i), a_i in zip(
                    zip(s_hist, y_hist, rho_hist), reversed(alphas)):
                b_i = r_i * dot(y_i, q)
                q = q + (a_i - b_i) * s_i
            d = -q                        # descent direction
            gd = dot(g, d)
            if gd >= 0:                   # not a descent direction: reset
                s_hist, y_hist, rho_hist = [], [], []
                d = -g * (0.01 / max(rms, 1e-6))
                gd = dot(g, d)
            # clip to the trust region
            dmax = float(torch.max(torch.abs(d)))
            if dmax > step_cap:
                scale = step_cap / dmax
                d = d * scale
                gd *= scale
            # Armijo backtracking
            t = 1.0
            for _ls in range(20):
                new_pos = pos + t * d
                e_new, f_new = e_and_f(new_pos, box)
                if math.isfinite(e_new) and e_new <= e + 1e-4 * t * gd:
                    break
                t *= 0.5
            else:
                break                     # line search failed: converged-ish
            g_new = -f_new
            s_vec = t * d
            y_vec = g_new - g
            sy = dot(s_vec, y_vec)
            if sy > 1e-10:
                s_hist.append(s_vec)
                y_hist.append(y_vec)
                rho_hist.append(1.0 / sy)
                if len(s_hist) > history:
                    s_hist.pop(0)
                    y_hist.pop(0)
                    rho_hist.pop(0)
            pos, e, f, g = new_pos, e_new, f_new, g_new
        ctx.set_positions(place(pos))
        return float(e)


# --------------------------------------------------------------- checkpoint
_TENSOR_FIELDS = ("pos", "pos_err", "vel", "box", "nh_eta", "nh_eta_dot",
                  "nh_eta_dotdot")


def save_checkpoint(context: Context, filename):
    """Full-state checkpoint in the JAX package's layout,
    ``{"state": {...}, "version": 1}``: the State's tensors as numpy
    arrays, the generator as ``generator.get_state().numpy()`` beside its
    device's kind, and step, time and cos_v as numbers.  The barostat's
    state (its move size and counters) is not saved, as in the JAX
    package.  On a mesh rank 0 writes it and every rank waits for it."""
    st = context.state
    if writes_files():
        data = {k: getattr(st, k).cpu().numpy() for k in _TENSOR_FIELDS}
        data.update(generator=st.generator.get_state().numpy(),
                    generator_device=st.generator.device.type, step=st.step,
                    time=st.time, cos_v=float(st.cos_v))
        with open(filename, "wb") as f:
            pickle.dump({"state": data, "version": 1}, f)
    if context.mesh is not None:
        context.mesh.barrier()


def load_checkpoint(context: Context, filename):
    """Restore every State field and the generator from ``filename``, then
    drop the VV scheme's force carry (the next ``step()`` builds a fresh
    pair cache in any case).

    A generator's state belongs to its device's kind (the CPU's Mersenne
    Twister, the card's Philox seed and offset).  A checkpoint written on
    the other kind seeds the generator from the first 8 bytes of the saved
    state's SHA-256: the load is deterministic, but the Langevin stream
    leaves the one the uninterrupted run would have drawn.

    A checkpoint written by the JAX package (it carries ``rng_key``) is
    read through ``state_from_numpy``, with the generator seeded from the
    key's two words: the Langevin stream then differs from the JAX
    package's, as it does from any start."""
    with open(filename, "rb") as f:
        blob = pickle.load(f)
    fields = blob["state"]
    dev = context.device
    if "rng_key" in fields:
        key = np.asarray(fields["rng_key"], np.uint32)
        context.state = state_from_numpy(
            SimpleNamespace(**fields), device=dev,
            seed=(int(key[0]) << 32) | int(key[1]))
    else:
        saved = np.asarray(fields["generator"], np.uint8)
        gen = torch.Generator(device=dev)
        if fields["generator_device"] == gen.device.type:
            gen.set_state(torch.as_tensor(saved))
        else:
            gen.manual_seed(int.from_bytes(
                hashlib.sha256(saved.tobytes()).digest()[:8], "little"))
        context.state = State(
            **{k: torch.as_tensor(fields[k], device=dev)
               for k in _TENSOR_FIELDS},
            generator=gen, step=int(fields["step"]),
            time=float(fields["time"]), cos_v=float(fields["cos_v"]))
    context._forces_valid = False
    context._forces_extra = torch.zeros_like(context.state.pos)


# ----------------------------------------------------------------- reporters
class _BaseReporter:
    def __init__(self, file, report_interval, append=False):
        self._interval = int(report_interval)
        if not writes_files():
            self._out = open(os.devnull, "w")
            self._own = True
        elif hasattr(file, "write"):
            self._out = file
            self._own = False
        else:
            self._out = open(file, "a" if append else "w")
            self._own = True
        self._initialized = False

    def describeNextReport(self, simulation):
        return self._interval - simulation.current_step % self._interval

    def _flush(self):
        if hasattr(self._out, "flush"):
            self._out.flush()

    def close(self):
        # getattr: __del__ also runs after an __init__ that failed to open
        if getattr(self, "_own", False) and not self._out.closed:
            self._out.close()

    def __del__(self):
        self.close()


class StateDataReporter(_BaseReporter):
    """Step, time, energies, temperature, volume, box, density, speed,
    elapsed and remaining time, and collective-variable columns, in the
    JAX package's formats (the reference statedatareporter.py:120-302),
    with its NaN/inf abort (:375-388)."""

    def __init__(self, file, report_interval, volume=False, density=True,
                 box=True, append=False, progress=False, remaining_time=False,
                 elapsed_time=True, total_steps=None, cvs=()):
        super().__init__(file, report_interval, append)
        if (progress or remaining_time) and total_steps is None:
            raise ValueError("Reporting progress or remaining time requires "
                             "total steps to be specified")
        self._volume = volume
        self._density = density
        self._box = box
        self._progress = progress
        self._remaining = remaining_time
        self._elapsed = elapsed_time
        self._total_steps = total_steps
        self._cvs = list(cvs)          # callables: cv(context) -> float
        self._t0 = None
        self._sim_t0 = None
        self._steps0 = None

    def report(self, simulation):
        ctx = simulation.context
        if not self._initialized:
            cols = []
            if self._progress:
                cols += ['#"Progress (%)"', '"Step"']
            else:
                cols += ['#"Step"']
            cols += ['"Time (ps)"', '"Potential Energy (kJ/mole)"',
                     '"Kinetic Energy (kJ/mole)"', '"Total Energy (kJ/mole)"',
                     '"Temperature (K)"']
            if self._volume:
                cols += ['"Volume (nm^3)"']
            if self._box:
                cols += ['"Lx"', '"Ly"', '"Lz"']
            if self._density:
                cols += ['"Density (g/mL)"']
            cols += ['"Speed (ns/day)"']
            if self._elapsed:
                cols += ['"Elapsed Time (hr)"']
            if self._remaining:
                cols += ['"Time Remaining"']
            for i in range(len(self._cvs)):
                cols += [f'"CV{i}"']
            print("\t".join(cols), file=self._out)
            self._initialized = True
            self._t0 = time.time()
            self._sim_t0 = ctx.time
            self._steps0 = ctx.current_step
        epot = ctx.potential_energy()
        ekin = ctx.kinetic_energy()
        if not (math.isfinite(epot) and math.isfinite(ekin)):
            raise RuntimeError(
                "Simulation blew up: energy is NaN/inf "
                "(statedatareporter.py:375-388 error check)")
        sysm = ctx.system
        n_cons = sysm.constraints.shape[0]
        n_massive = int(np.sum(np.asarray(sysm.masses) > 0))
        dof = 3 * n_massive - n_cons - (3 if sysm.has_cm_motion_remover else 0)
        temp = 2 * ekin / (dof * BOLTZ)
        box = ctx.get_box()
        vol = float(box[0] * box[1] * box[2])
        now = time.time()
        vals = []
        if self._progress:
            vals += [f"{100.0 * ctx.current_step / self._total_steps:.1f}%"]
        vals += [str(ctx.current_step), f"{ctx.time:.3f}", f"{epot:.2f}",
                 f"{ekin:.2f}", f"{epot + ekin:.2f}", f"{temp:.2f}"]
        if self._volume:
            vals += [f"{vol:.4f}"]
        if self._box:
            vals += [f"{box[0]:.4f}", f"{box[1]:.4f}", f"{box[2]:.4f}"]
        if self._density:
            mass_g = float(np.sum(np.asarray(sysm.masses)))  # g/mol
            dens = mass_g / AVOGADRO / (vol * 1e-21)         # g/mL
            vals += [f"{dens:.4f}"]
        elapsed_days = (now - self._t0) / 86400.0
        elapsed_ns = (ctx.time - self._sim_t0) / 1000.0
        vals += [f"{elapsed_ns / elapsed_days:.3g}" if elapsed_days > 0
                 else "--"]
        if self._elapsed:
            vals += [f"{(now - self._t0) / 3600.0:.3g}"]
        if self._remaining:
            steps_done = ctx.current_step - self._steps0
            if steps_done == 0:
                vals += ["--"]
            else:
                secs = int((self._total_steps - ctx.current_step)
                           * (now - self._t0) / steps_done)
                d, secs = divmod(secs, 86400)
                h, secs = divmod(secs, 3600)
                mnt, secs = divmod(secs, 60)
                if d > 0:
                    vals += [f"{d}:{h}:{mnt:02d}:{secs:02d}"]
                elif h > 0:
                    vals += [f"{h}:{mnt:02d}:{secs:02d}"]
                else:
                    vals += [f"{mnt}:{secs:02d}"]
        for cv in self._cvs:
            vals += [f"{float(cv(ctx)):.6g}"]
        print("\t".join(vals), file=self._out)
        self._flush()


class DrudeTemperatureReporter(_BaseReporter):
    """T_COM / T_atom / T_Drude partition in the lab frame, re-derived in
    numpy from the velocities (the reference
    drudetemperaturereporter.py:96-133)."""

    def report(self, simulation):
        ctx = simulation.context
        sysm = ctx.system
        vel = ctx.get_velocities()
        n = vel.shape[0]                # mesh-padding ghosts left out
        masses = np.asarray(sysm.masses)[:n]
        if not self._initialized:
            print('#"Step"\t"T_COM"\t"T_Atom"\t"T_Drude"\t"KE_COM"\t"KE_Atom"'
                  '\t"KE_Drude"', file=self._out)
            self.mol_id = np.asarray(sysm.particle_mol_id)[:n]
            self.mol_mass = np.asarray(sysm.mol_masses)
            self.dof_com = int(np.count_nonzero(self.mol_mass)) * 3
            self.dof_atom = int(np.sum(masses > 0)) * 3
            self.dof_atom -= self.dof_com + sysm.constraints.shape[0]
            if sysm.has_cm_motion_remover:
                self.dof_com -= 3
            nd = sysm.drude_pairs.shape[0]
            self.dof_atom -= 3 * nd
            self.dof_drude = 3 * nd
            self._initialized = True
        mol_vel = np.zeros((len(self.mol_mass), 3))
        np.add.at(mol_vel, self.mol_id, masses[:, None] * vel)
        nonzero = self.mol_mass > 0
        mol_vel[nonzero] /= self.mol_mass[nonzero][:, None]
        ke_com = 0.5 * float(np.sum(self.mol_mass * (mol_vel ** 2).sum(-1)))
        vel = vel - mol_vel[self.mol_id]
        pairs = np.asarray(sysm.drude_pairs)
        m = masses.copy()
        is_drude = np.zeros(len(m), bool)
        if len(pairs):
            d, p = pairs[:, 0], pairs[:, 1]
            m1, m2 = masses[d], masses[p]
            mc = m1 + m2
            v_cm = (m1[:, None] * vel[d] + m2[:, None] * vel[p]) / mc[:, None]
            v_rel = vel[d] - vel[p]
            vel[d] = v_rel
            vel[p] = v_cm
            m[d] = m1 * m2 / mc
            m[p] = mc
            is_drude[d] = True
        mvv = m * (vel ** 2).sum(-1)
        ke_drude = 0.5 * float(mvv[is_drude].sum())
        ke_atom = 0.5 * float(mvv[~is_drude].sum())
        t_com = 2 * ke_com / (self.dof_com * BOLTZ) if self.dof_com else 0.0
        t_atom = 2 * ke_atom / (self.dof_atom * BOLTZ) if self.dof_atom else 0.0
        t_drude = (2 * ke_drude / (self.dof_drude * BOLTZ) if self.dof_drude
                   else 0.0)
        print(f"{simulation.current_step}\t{t_com:.4f}\t{t_atom:.4f}\t"
              f"{t_drude:.4f}\t{ke_com:.4f}\t{ke_atom:.4f}\t{ke_drude:.4f}",
              file=self._out)
        self._flush()


class ViscosityReporter(_BaseReporter):
    """Periodic-perturbation viscosity (the reference
    viscosityreporter.py:54-72)."""

    def report(self, simulation):
        ctx = simulation.context
        if not self._initialized:
            print('#"Step"\t"Acceleration (nm/ps^2)"\t"VelocityAmplitude '
                  '(nm/ps)"\t"1/Viscosity (1/Pa.s)"', file=self._out)
            self._initialized = True
        acc = ctx.integrator.getCosAcceleration()
        vmax, inv_vis = ctx.get_viscosity()
        print(f"{simulation.current_step}\t{acc}\t{vmax}\t{inv_vis}",
              file=self._out)
        self._flush()


class GroReporter(_BaseReporter):
    """GRO trajectory with optional logarithmic spacing (the reference
    groreporter.py:46-72)."""

    def __init__(self, file, report_interval, logarithm=False, subset=None,
                 report_velocity=False, append=False):
        super().__init__(file, report_interval, append)
        self._log = logarithm
        self._subset = subset
        self._vel = report_velocity

    def describeNextReport(self, simulation):
        if self._log:
            step = simulation.current_step
            base = (self._interval if step < self._interval
                    else 10 ** math.floor(math.log10(step)))
            return base - step % base
        return super().describeNextReport(simulation)

    def report(self, simulation):
        from .models.grofile import GroFile
        ctx = simulation.context
        GroFile.writeFile(simulation.topology, ctx.get_positions(),
                          ctx.get_box(), self._out, time=ctx.time,
                          subset=self._subset,
                          velocities=ctx.get_velocities() if self._vel else None)
        self._flush()


def encode_dcd_frame(pos_nm, box_nm) -> bytes:
    """One DCD frame: the unit-cell record (a, gamma, b, beta, alpha, c in
    Angstrom, cosines 0) and the X, Y, Z float32 records in Angstrom, each
    between Fortran record markers.

    The JAX package's reporter scales float32 nm by 10, divides by 10 and
    hands the result to its C encoder, which scales by 10.0f again; for
    every normal float32 that gives the bytes of one scaling by 10
    (tests/test_torch_app.py checks every mantissa), which is what this
    encoder does.  The box is float32 widened to float64, where both paths
    are exact."""
    xyz = np.asarray(pos_nm, np.float32) * np.float32(10.0)
    box = np.asarray(box_nm, np.float64) * 10.0
    n = xyz.shape[0]
    cell = np.array([box[0], 0.0, box[1], 0.0, 0.0, box[2]], "<f8")
    rec = struct.pack("<i", 4 * n)
    parts = [struct.pack("<i", 48), cell.tobytes(), struct.pack("<i", 48)]
    for axis in range(3):
        parts += [rec, np.ascontiguousarray(xyz[:, axis], "<f4").tobytes(),
                  rec]
    return b"".join(parts)


class DCDReporter:
    """Binary CHARMM/X-PLOR DCD trajectory (the reference workloads attach
    OpenMM's app.DCDReporter, run-bulk.py:90): Fortran record markers, a
    CORD header with the unit-cell flag, and per frame the unit cell and
    the X/Y/Z float32 records in Angstrom (``encode_dcd_frame``).

    Frames are written by a background thread, so trajectory output does
    not block the step; ``flush()`` waits for them and raises the first
    error the writer met.  In append mode NSET continues from the
    existing file's header."""

    def __init__(self, file, report_interval, append=False):
        self._interval = int(report_interval)
        self._path = file
        self._n_frames = 0
        self._append = append
        self._fh = None
        self._error = None
        self._queue = queue.Queue(maxsize=16)
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    def _writer(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                break
            try:
                self._write_frame(*item)
            except Exception as exc:   # kept for flush() to raise
                if self._error is None:
                    self._error = exc
            finally:
                self._queue.task_done()

    def describeNextReport(self, simulation):
        return self._interval - simulation.current_step % self._interval

    def _write_header(self, n_atoms, dt_ps, first_step):
        fh = self._fh
        # 84-byte CORD block
        fh.write(struct.pack("<i4s", 84, b"CORD"))
        icntrl = [0] * 20
        icntrl[1] = first_step              # ISTART
        icntrl[2] = self._interval          # NSAVC
        icntrl[9] = int(dt_ps / 4.888821e-2 * 1000) & 0x7FFFFFFF  # AKMA dt
        icntrl[10] = 1                      # unit cell present
        icntrl[19] = 24                     # CHARMM version
        fh.write(struct.pack("<9if10i", *icntrl[:9],
                             dt_ps / 4.888821e-2 * 1000.0, *icntrl[10:]))
        fh.write(struct.pack("<i", 84))
        title = b"Created by openmm_velocityverlet_tpu_torch".ljust(80)
        fh.write(struct.pack("<ii", 84, 1) + title + struct.pack("<i", 84))
        fh.write(struct.pack("<iii", 4, n_atoms, 4))

    def _open(self, n, simulation):
        mode = "r+b" if self._append else "wb"
        try:
            self._fh = open(self._path, mode)
        except FileNotFoundError:
            self._fh = open(self._path, "wb")
            mode = "wb"
        if mode == "r+b":
            # continue NSET from the existing header, so the appended
            # file's frame count covers the frames before the restart
            self._fh.seek(8)
            self._n_frames = struct.unpack("<i", self._fh.read(4))[0]
            self._fh.seek(188)
            n_existing = struct.unpack("<i", self._fh.read(4))[0]
            if n_existing != n:
                raise ValueError(
                    f"appending {n} atoms to a DCD with {n_existing}")
            self._fh.seek(0, 2)
        else:
            self._write_header(n, float(
                simulation.context.integrator.getStepSize()),
                simulation.current_step)

    def _write_frame(self, frame, nset):
        fh = self._fh
        fh.seek(0, 2)
        fh.write(frame)
        fh.seek(8)
        fh.write(nset)
        fh.flush()

    def report(self, simulation):
        if not writes_files():
            return
        ctx = simulation.context
        pos = ctx.get_positions()
        if self._fh is None:
            self._open(pos.shape[0], simulation)
        frame = encode_dcd_frame(pos, ctx.get_box())
        self._n_frames += 1
        self._queue.put((frame, struct.pack("<i", self._n_frames)))

    def flush(self):
        """Block until every queued frame is in the file (readers, and the
        NSET patch, are consistent only after this)."""
        if self._queue is not None:
            self._queue.join()
        if self._fh is not None:
            self._fh.flush()
        if self._error is not None:
            raise self._error

    def close(self):
        if self._queue is not None:
            self._queue.put(None)      # after the frames already queued
            self._thread.join()
            self._queue = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._error is not None:
            raise self._error

    def __del__(self):
        try:
            self.close()
        except Exception:   # an exception cannot leave __del__
            pass


class CheckpointReporter:
    """Step-suffixed checkpoints, ``{file}_{step}``, keeping the last 3
    (the reference checkpointreporter.py:52-79)."""

    def __init__(self, file, report_interval):
        self._interval = int(report_interval)
        self._file = file

    def describeNextReport(self, simulation):
        return self._interval - simulation.current_step % self._interval

    def report(self, simulation):
        step = simulation.current_step
        save_checkpoint(simulation.context, f"{self._file}_{step}")
        prev = f"{self._file}_{step - 3 * self._interval}"
        if writes_files() and os.path.exists(prev):
            os.remove(prev)
