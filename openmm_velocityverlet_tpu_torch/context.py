"""Context: binds System + VVIntegrator + ForceEvaluator and owns the
dynamic state (counterpart of ``openmm_velocityverlet_tpu/context.py``).

``step(n)`` runs the middle scheme (VVIntegrator::stepMiddle,
VVIntegrator.cpp:232-338), or the vanilla VV scheme (stepVV) after
``setUseMiddleScheme(False)``, eagerly on ``device`` (the card unless the
caller passes ``device="cpu"``): CM-motion removal, forces with the cached
pair sort (plist list or z band) plus the extra forces (E-field, cosine
acceleration; in the VV scheme also the Langevin drag and noise), the
kicks, RATTLE, the TGNH thermostat with the cosine velocity bias removed
and restored around it, the Langevin Ornstein-Uhlenbeck map (middle
scheme), drift on compensated two-float positions, SHAKE with its velocity
correction and the Drude hard wall.  The VV scheme carries the forces of
the step's second evaluation into the next step, across ``step()`` calls
and cache rebuilds; ``set_positions`` and ``set_velocities`` invalidate
them.  Langevin noise is drawn from ``State.generator`` (its numbers differ
from the JAX threefry stream).

The steps run in segments: the pair
cache is rebuilt at the entry of each ``step()``, every ``sort_refresh``
steps, and right after a step whose coverage flag tripped.  Reading that
flag is the one host synchronisation of a step (with ``strict_pairs`` the
evaluator reads it before the sweep, since the step's forces depend on
it), and checking a fresh plist cache's overflow flag the one of a rebuild
(both counted in ``host_syncs``).  Unlike the JAX
package, a flagged rebuild (list overflow, or a nowrap frame that no longer
fits) is refitted from the current configuration before it runs, instead of
running the flagged list (ROADMAP C).

What this port does not carry raises NotImplementedError at construction:
image pairs (A11), the barostat (A12) and the mesh (A16).
"""
from __future__ import annotations

import sys
from typing import Sequence

import numpy as np
import torch

from .forces import ForceEvaluator
from .integrators import stepping
from .integrators.vv import IntegratorData, VVIntegrator
from .ops import constraints as cons_mod
from .system import State, System, make_state, resolve_device
from .units import BOLTZ


def _refuse_unported(data: IntegratorData, barostat, mesh):
    if data.image_pairs.shape[0]:
        raise NotImplementedError(
            "image pairs (constant voltage) are not ported yet (ROADMAP A11)")
    if barostat is not None:
        raise NotImplementedError(
            "the Monte Carlo barostat is not ported yet (ROADMAP A12)")
    if mesh is not None:
        raise NotImplementedError(
            "the multi-device mesh is not ported yet (ROADMAP A16)")


class Context:
    def __init__(self, system: System, integrator: VVIntegrator,
                 external_forces: Sequence = (), barostat=None,
                 positions=None, box=None, row_block: int = 1024,
                 ewald_chunk: int = 4096, sort_refresh: int = 120,
                 pair_ts: int = 0, fold_exc14: bool = False,
                 recip: str = "exact", mesh=None,
                 strict_pairs: bool = False, pair_kernel: str = "auto",
                 device="cuda"):
        if box is None:
            raise ValueError("box is required")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the reciprocal contraction must stay in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.system = system
        self.integrator = integrator
        self.data: IntegratorData = integrator.build_data(system)
        _refuse_unported(self.data, barostat, mesh)
        self.sort_refresh = int(sort_refresh)
        box = np.asarray(box, np.float32)
        self.evaluator = ForceEvaluator(
            system, external_forces, ewald_chunk=ewald_chunk,
            row_block=row_block, pair_ts=pair_ts, fold_exc14=fold_exc14,
            recip=recip, box_hint=box, pos_hint=positions, mesh=mesh,
            strict_pairs=strict_pairs, pair_kernel=pair_kernel,
            device=self.device)
        self.cons = cons_mod.build_constraint_data(
            np.asarray(system.constraints), np.asarray(system.constraint_dist),
            np.asarray(system.inv_masses),
            tolerance=integrator.constraint_tolerance, device=self.device)
        n = system.n_atoms
        self.state: State = make_state(
            np.zeros((n, 3), np.float32) if positions is None else positions,
            box, num_nh_chains=integrator.num_nh_chains,
            seed=integrator.random_number_seed, device=self.device)
        t = self.evaluator.t
        self._masses = t.masses
        self._inv_m = t.inv_masses
        data = self.data
        inv_m_np = np.asarray(system.inv_masses, np.float32)
        self._dt_inv_m = torch.as_tensor(
            (data.dt * inv_m_np).astype(np.float32),
            device=self.device)[:, None]
        self._half_dt_inv_m = torch.as_tensor(
            (0.5 * data.dt * inv_m_np).astype(np.float32),
            device=self.device)[:, None]
        self._total_mass = float(np.sum(np.asarray(system.masses)))
        self._thermo = stepping.thermostat_tables(system, data, self.device)
        self._hardwall = stepping.hardwall_tables(system, data, self.device)
        self._langevin = stepping.langevin_tables(system, data, self.device)
        # the E-field force is a constant (N,3) table; none without a field
        self._efield = None
        if data.electrolyte.shape[0] and data.electric_field != 0:
            fz = stepping.efield_extra_force(np.asarray(system.charges), data)
            self._efield = torch.as_tensor(
                fz[:, None] * np.asarray([0.0, 0.0, 1.0], np.float32),
                device=self.device)
        self._ex = torch.tensor([1.0, 0.0, 0.0], device=self.device)
        self._has_extra = (self._langevin is not None
                           or self._efield is not None
                           or data.cos_acceleration != 0)
        # the VV scheme's force carry (the JAX Carry.forces, forces_extra,
        # forces_valid)
        self._forces = None
        self._forces_extra = torch.zeros((system.n_atoms, 3),
                                         device=self.device)
        self._forces_valid = False
        # counters of the segment loop: cache rebuilds, segments ended by
        # a coverage trip, pair-list refits, and host reads of device
        # values during step()
        self.rebuilds = 0
        self.coverage_rebuilds = 0
        self.refits = 0
        self.host_syncs = 0
        if positions is not None:
            self.set_positions(positions)

    # --------------------------------------------------------- public API
    def _tensor(self, arr):
        if isinstance(arr, torch.Tensor):
            return arr.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(arr, np.float32),
                               device=self.device)

    @torch.no_grad()
    def set_positions(self, positions):
        """New positions; the VV scheme's carried forces (extra forces
        included) are dropped, as the JAX package drops its carry."""
        pos = self.evaluator.place_vsites(self._tensor(positions))
        self.state = self.state.replace(pos=pos, pos_err=torch.zeros_like(pos))
        self._forces_valid = False
        self._forces_extra = torch.zeros_like(pos)

    def set_velocities(self, velocities):
        """New velocities; the VV scheme recomputes its carried forces at
        the next step."""
        self.state = self.state.replace(vel=self._tensor(velocities))
        self._forces_valid = False

    def set_velocities_to_temperature(self, temperature, seed=12345):
        """Maxwell-Boltzmann velocities from a ``torch.Generator`` seeded
        with ``seed`` (its numbers differ from the JAX package's)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        sigma = torch.sqrt(BOLTZ * temperature * self._inv_m)[:, None]
        self.set_velocities(sigma * torch.randn(
            (self.system.n_atoms, 3), generator=g, dtype=torch.float32,
            device=self.device))

    @torch.no_grad()
    def get_positions(self):
        """Positions with virtual sites re-placed in their parent frames."""
        return self.evaluator.place_vsites(self.state.pos).cpu().numpy()

    def get_velocities(self):
        return self.state.vel.cpu().numpy()

    def get_box(self):
        return self.state.box.cpu().numpy()

    @property
    def time(self):
        return self.state.time

    @property
    def current_step(self):
        return self.state.step

    def kinetic_energy(self):
        return float(stepping.kinetic_energy(self.state.vel, self._masses))

    def potential_energy_terms(self):
        terms, _ = self.evaluator.energy_forces(self.state.pos,
                                                self.state.box)
        return {k: float(v) for k, v in terms.items()}

    def potential_energy(self):
        return sum(self.potential_energy_terms().values())

    def group_energies(self):
        return {g: float(v) for g, v in self.evaluator.group_energies(
            self.potential_energy_terms()).items()}

    def get_forces(self):
        _, f = self.evaluator.energy_forces(self.state.pos, self.state.box)
        return f.cpu().numpy()

    def get_viscosity(self):
        """(vMax nm/ps, 1/viscosity in 1/(Pa s)) -- VVIntegrator::
        getViscosity (VVIntegrator.cpp:378-383) with the SWIG unit
        conversion applied; vMax is the cosine velocity amplitude of the
        last thermostat application."""
        a = self.data.cos_acceleration
        v = torch.as_tensor(self.state.cos_v, dtype=torch.float32,
                            device=self.device)
        inv_vis_md = float(stepping.inverse_viscosity(
            v, self.state.box, self._masses, a)) if a else 0.0
        return float(v), inv_vis_md * 6.02214076e5

    # ------------------------------------------------------------ stepping
    def _fresh_cache(self):
        """A pair cache for the current positions.  A z-band cache has no
        list to flag; a plist rebuild whose list overflowed or whose nowrap
        frame budget failed refits the list from the current configuration
        and rebuilds (one host read per plist rebuild)."""
        ev, st = self.evaluator, self.state
        if ev.pair_mode == "band":
            self.rebuilds += 1
            return ev.make_pair_cache(st.pos, st.box)
        for _ in range(3):
            cache = ev.make_pair_cache(st.pos, st.box)
            self.rebuilds += 1
            self.host_syncs += 1
            if not bool(cache.overflow):
                return cache
            note = ev.refit_pair_list(st.pos, st.box)
            self.refits += 1
            print(f"[vv-torch] pair list refit after a flagged rebuild: "
                  f"{note}", file=sys.stderr)
        raise RuntimeError("pair list still flagged after refitting")

    @torch.no_grad()
    def step(self, n: int):
        """Advance ``n`` steps of the integrator's scheme in cache segments
        (see the module doc)."""
        ev = self.evaluator
        one_step = self._step_middle if self.data.use_middle else \
            self._step_vv
        n = int(n)
        done = 0
        while done < n:
            cache = self._fresh_cache() if ev.uses_band else None
            lim = min(done + self.sort_refresh, n)
            while done < lim:
                cov = one_step(cache)
                done += 1
                if ev.uses_band:
                    # with strict_pairs the evaluator has read the flag
                    # already, before the kick, and cov is a Python bool
                    self.host_syncs += 1
                    if bool(cov):
                        self.coverage_rebuilds += 1
                        break

    def _draws(self, *shapes):
        """Standard normal float32 draws from the State's generator, one
        tensor per shape, in order."""
        g = self.state.generator
        return [torch.randn(s, generator=g, dtype=torch.float32,
                            device=self.device) for s in shapes]

    def _extra_forces(self, pos, vel, box, ld_as_force):
        """Langevin drag and noise (only with ``ld_as_force``: the VV
        scheme), the E-field and the cosine acceleration, summed in the
        JAX ``extra_forces`` order."""
        f = torch.zeros_like(pos)
        lt = self._langevin
        if lt is not None and ld_as_force:
            xi_n, xi_p = self._draws((lt["n_normal"], 3),
                                     (lt["n_pairs"], 2, 3))
            f = f + stepping.langevin_extra_force(vel, lt, xi_n, xi_p)
        if self._efield is not None:
            f = f + self._efield
        if self.data.cos_acceleration != 0:
            fx = stepping.cos_extra_force(pos, self._masses, box,
                                          self.data.cos_acceleration)
            f = f + fx[:, None] * self._ex
        return f

    def _thermostat(self, pos, vel, box, st: State):
        """The TGNH block with the cosine velocity bias removed before and
        restored after it (VVIntegrator.cpp:251-260); the bias amplitude is
        kept in the State for ``get_viscosity``."""
        cos_v = st.cos_v
        has_cos = self.data.cos_acceleration != 0
        if has_cos:
            cos_v = stepping.cos_velocity_bias(pos, vel, self._masses, box)
            vel = stepping.cos_shift_velocity(pos, vel, box, cos_v, -1.0)
        vel, eta, eta_dot, eta_dotdot, _ = stepping.nh_scale_velocities(
            vel, self.data, self._thermo, st.nh_eta, st.nh_eta_dot,
            st.nh_eta_dotdot)
        if has_cos:
            vel = stepping.cos_shift_velocity(pos, vel, box, cos_v, 1.0)
        return vel, st.replace(nh_eta=eta, nh_eta_dot=eta_dot,
                               nh_eta_dotdot=eta_dotdot, cos_v=cos_v)

    def _remove_cm_motion(self, vel):
        if self.system.has_cm_motion_remover:
            vcm = torch.sum(self._masses[:, None] * vel, 0) / self._total_mass
            vel = torch.where(self._inv_m[:, None] > 0, vel - vcm, vel)
        return vel

    def _step_middle(self, cache):
        """One middle-scheme step (stepMiddle); returns the coverage flag."""
        data, cons, st = self.data, self.cons, self.state
        has_cons = cons.n_constraints > 0
        vel = self._remove_cm_motion(st.vel)
        pos, err, box = st.pos, st.pos_err, st.box
        _, F, cov = self.evaluator.energy_forces(
            pos, box, want_energy=False, pair_cache=cache, return_cov=True)
        if self._has_extra:
            # Langevin runs as the exact OU map below, not as a force
            F = F + self._extra_forces(pos, vel, box, ld_as_force=False)
        dt = data.dt
        vel = vel + self._dt_inv_m * F                       # full kick
        if has_cons:
            vel = cons_mod.apply_velocity_constraints(pos, vel, box, cons,
                                                      self._inv_m)
        half1 = 0.5 * dt * vel
        if data.nh_normal.shape[0] + data.nh_pairs.shape[0]:
            vel, st = self._thermostat(pos, vel, box, st)
        lt = self._langevin
        if lt is not None:
            n = self.system.n_atoms
            xi_n, xi_p = self._draws((n, 3) if lt["n_normal"] else (0, 3),
                                     (n, 2, 3) if lt["n_pairs"]
                                     else (0, 2, 3))
            vel = stepping.langevin_ou_update(vel, lt, xi_n, xi_p)
            if has_cons:
                vel = cons_mod.apply_velocity_constraints(
                    pos, vel, box, cons, self._inv_m)
        delta = half1 + 0.5 * dt * vel
        new_pos, new_err = stepping.compensated_add(pos, err, delta)
        if has_cons:
            con_pos = cons_mod.apply_position_constraints(
                pos, new_pos, box, cons, self._inv_m)
            vel = vel + (con_pos - new_pos) / dt
            new_pos, new_err = stepping.compensated_add(
                new_pos, new_err, con_pos - new_pos)
        hw_pos, vel = stepping.apply_hardwall(new_pos, vel, self._hardwall)
        new_pos, new_err = stepping.compensated_add(new_pos, new_err,
                                                    hw_pos - new_pos)
        self.state = st.replace(pos=new_pos, pos_err=new_err, vel=vel,
                                step=st.step + 1, time=st.time + dt)
        return cov

    def _step_vv(self, cache):
        """One vanilla VV step (stepVV): thermostat, half kick with the
        carried forces, drift with SHAKE (the constrained displacement sets
        the velocity), hard wall, forces and extra forces at the new
        positions, half kick, RATTLE, thermostat.  The new forces are
        carried into the next step; returns the coverage flag of their
        evaluation."""
        data, cons, st, ev = self.data, self.cons, self.state, self.evaluator
        has_cons = cons.n_constraints > 0
        has_nh = data.nh_normal.shape[0] + data.nh_pairs.shape[0] > 0
        vel = self._remove_cm_motion(st.vel)
        pos, err, box = st.pos, st.pos_err, st.box
        if self._forces_valid:
            F = self._forces
        else:
            _, F = ev.energy_forces(pos, box, want_energy=False,
                                    pair_cache=cache)
            if ev.strict_pairs and ev.uses_band:
                self.host_syncs += 1
        dt = data.dt
        if has_nh:
            vel, st = self._thermostat(pos, vel, box, st)
        vel = vel + self._half_dt_inv_m * (F + self._forces_extra)
        new_pos, new_err = stepping.compensated_add(pos, err, dt * vel)
        if has_cons:
            con_pos = cons_mod.apply_position_constraints(
                pos, new_pos, box, cons, self._inv_m)
            new_pos, new_err = stepping.compensated_add(
                new_pos, new_err, con_pos - new_pos)
            # velocityVerletIntegratePositions sets vel = delta/dt after the
            # constraints (velocityVerlet.cu:35-68)
            vel = torch.where(self._inv_m[:, None] > 0, (con_pos - pos) / dt,
                              vel)
        hw_pos, vel = stepping.apply_hardwall(new_pos, vel, self._hardwall)
        new_pos, new_err = stepping.compensated_add(new_pos, new_err,
                                                    hw_pos - new_pos)
        _, F2, cov = ev.energy_forces(new_pos, box, want_energy=False,
                                      pair_cache=cache, return_cov=True)
        Fx2 = (self._extra_forces(new_pos, vel, box, ld_as_force=True)
               if self._has_extra else torch.zeros_like(F2))
        vel = vel + self._half_dt_inv_m * (F2 + Fx2)
        if has_cons:
            vel = cons_mod.apply_velocity_constraints(new_pos, vel, box, cons,
                                                      self._inv_m)
        if has_nh:
            vel, st = self._thermostat(new_pos, vel, box, st)
        self.state = st.replace(pos=new_pos, pos_err=new_err, vel=vel,
                                step=st.step + 1, time=st.time + dt)
        self._forces, self._forces_extra = F2, Fx2
        self._forces_valid = True
        return cov
