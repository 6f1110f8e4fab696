"""Context: binds System + VVIntegrator + ForceEvaluator and owns the
dynamic state (counterpart of ``openmm_velocityverlet_tpu/context.py``).

``step(n)`` runs the middle scheme (VVIntegrator::stepMiddle,
VVIntegrator.cpp:232-338) eagerly on ``device`` (the card unless the
caller passes ``device="cpu"``): CM-motion removal, forces with the cached
pair sort (plist list or z band), full kick, RATTLE, the TGNH thermostat,
drift on compensated two-float positions, SHAKE with its velocity
correction and the Drude hard wall.  The steps run in segments: the pair
cache is rebuilt at the entry of each ``step()``, every ``sort_refresh``
steps, and right after a step whose coverage flag tripped.  Reading that
flag is the one host synchronisation of a step (with ``strict_pairs`` the
evaluator reads it before the sweep, since the step's forces depend on
it), and checking a fresh plist cache's overflow flag the one of a rebuild
(both counted in ``host_syncs``).  Unlike the JAX
package, a flagged rebuild (list overflow, or a nowrap frame that no longer
fits) is refitted from the current configuration before it runs, instead of
running the flagged list (ROADMAP C).

What this slice does not carry raises NotImplementedError at construction:
Langevin particles, the E-field and cosine acceleration (ROADMAP A10), the
vanilla VV scheme (A10), image pairs (A11), the barostat (A12) and the mesh
(A16).
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
    if data.ld_normal.shape[0] or data.ld_pairs.shape[0]:
        raise NotImplementedError(
            "partitioned Langevin particles are not ported yet (ROADMAP A10)")
    if data.electrolyte.shape[0] and data.electric_field != 0:
        raise NotImplementedError(
            "the external E-field is not ported yet (ROADMAP A10)")
    if data.cos_acceleration != 0:
        raise NotImplementedError(
            "cosine acceleration is not ported yet (ROADMAP A10)")
    if not data.use_middle:
        raise NotImplementedError(
            "setUseMiddleScheme(False), the vanilla VV step, is not ported "
            "yet (ROADMAP A10)")
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
        self._dt_inv_m = torch.as_tensor(
            (self.data.dt * np.asarray(system.inv_masses, np.float32)
             ).astype(np.float32), device=self.device)[:, None]
        self._total_mass = float(np.sum(np.asarray(system.masses)))
        self._thermo = stepping.thermostat_tables(system, self.data,
                                                  self.device)
        self._hardwall = stepping.hardwall_tables(system, self.data,
                                                  self.device)
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
        pos = self.evaluator.place_vsites(self._tensor(positions))
        self.state = self.state.replace(pos=pos, pos_err=torch.zeros_like(pos))

    def set_velocities(self, velocities):
        self.state = self.state.replace(vel=self._tensor(velocities))

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
        """Advance ``n`` middle-scheme steps in cache segments (see the
        module doc)."""
        ev = self.evaluator
        n = int(n)
        done = 0
        while done < n:
            cache = self._fresh_cache() if ev.uses_band else None
            lim = min(done + self.sort_refresh, n)
            while done < lim:
                cov = self._step_middle(cache)
                done += 1
                if ev.uses_band:
                    # with strict_pairs the evaluator has read the flag
                    # already, before the kick, and cov is a Python bool
                    self.host_syncs += 1
                    if bool(cov):
                        self.coverage_rebuilds += 1
                        break

    def _step_middle(self, cache):
        """One middle-scheme step (stepMiddle); returns the coverage flag."""
        data, cons, st = self.data, self.cons, self.state
        has_cons = cons.n_constraints > 0
        vel = st.vel
        if self.system.has_cm_motion_remover:
            vcm = torch.sum(self._masses[:, None] * vel, 0) / self._total_mass
            vel = torch.where(self._inv_m[:, None] > 0, vel - vcm, vel)
        pos, err, box = st.pos, st.pos_err, st.box
        _, F, cov = self.evaluator.energy_forces(
            pos, box, want_energy=False, pair_cache=cache, return_cov=True)
        dt = data.dt
        vel = vel + self._dt_inv_m * F                       # full kick
        if has_cons:
            vel = cons_mod.apply_velocity_constraints(pos, vel, box, cons,
                                                      self._inv_m)
        half1 = 0.5 * dt * vel
        eta, eta_dot, eta_dotdot = st.nh_eta, st.nh_eta_dot, st.nh_eta_dotdot
        if data.nh_normal.shape[0] + data.nh_pairs.shape[0]:
            vel, eta, eta_dot, eta_dotdot, _ = stepping.nh_scale_velocities(
                vel, data, self._thermo, eta, eta_dot, eta_dotdot)
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
        self.state = st.replace(
            pos=new_pos, pos_err=new_err, vel=vel, nh_eta=eta,
            nh_eta_dot=eta_dot, nh_eta_dotdot=eta_dotdot, step=st.step + 1,
            time=st.time + dt)
        return cov
