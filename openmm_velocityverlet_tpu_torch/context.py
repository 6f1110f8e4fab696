"""Context: binds System + VVIntegrator + ForceEvaluator and owns the
dynamic state (counterpart of ``openmm_velocityverlet_tpu/context.py``).

``step(n)`` runs the middle scheme (VVIntegrator::stepMiddle,
VVIntegrator.cpp:232-338), or the vanilla VV scheme (stepVV) after
``setUseMiddleScheme(False)``, eagerly on ``device`` (the card unless the
caller passes ``device="cpu"``): CM-motion removal, the Monte Carlo
barostat's attempt every ``frequency`` steps, forces with the cached pair
sort plus the extra forces (E-field, cosine acceleration; in the VV scheme
also the Langevin drag and noise), the kicks, RATTLE, the TGNH thermostat
with the cosine velocity bias removed and restored around it, the Langevin
Ornstein-Uhlenbeck map (middle scheme), drift on compensated two-float positions, SHAKE with its velocity
correction, the Drude hard wall and the image-charge sync (each image takes
its parent's x, y and the mirrored z, a virtual site's parent as placed;
``pos_err`` is zeroed on the rows it moved).  The E-field's force on a
virtual site is moved onto the site's parents once, at construction.  The
VV scheme carries the forces of the step's second evaluation into the next
step, across ``step()`` calls and cache rebuilds; ``set_positions`` and
``set_velocities`` invalidate them.  Langevin noise is drawn from
``State.generator`` (its numbers differ from the JAX threefry stream).

The steps run in segments when the evaluator's pair sweep
(``ForceEvaluator.pairs``, chosen there) carries a cache: the cache is
rebuilt at the entry of each ``step()``, every ``sort_refresh`` steps, and
right after a step whose coverage flag tripped.  Reading that flag is the
one host synchronisation of a step (a sweep with ``host_flag`` reads it
before the sweep, since the step's forces depend on it), and the sweep's
rebuild reports its own (one a build of a pair list, whose overflow flag
it checks); both are counted in ``host_syncs``.  Unlike the JAX package, a
flagged pair list (overflow, or a nowrap frame that no longer fits) is
refitted from the current configuration before it runs, instead of running
the flagged list (ROADMAP C); the sweep's rebuild does that and reports its
refits.

Constant voltage: when the image pairs are a contiguous trailing block
mirroring the block just before it, with q_img = -q_parent exactly, the
matmul reciprocal derives the images' structure factor from the parents'
(``ewald.reciprocal_energy(mirror=)``); any other layout takes the explicit
evaluation over all atoms.  The JAX package's detection admits parents that
end before the images begin and never checks the charges (ROADMAP C).

With ``cuda_graph=True`` the middle-scheme step is captured as a CUDA graph
at the first segment and replayed at every step (``step_graph.py``): the
host launches a step in one call instead of kernel by kernel.  Each
segment's fresh pair cache and the State are copied into the graph's
tensors; a cache of other shapes, or a refitted pair sweep, is captured
anew.  What a graph cannot hold (host reads inside the step, the
generator's draws, the barostat, the VV scheme, a mesh) is refused at
construction, with the reason.

The barostat's attempt reads its accept flag, and the flags of the two
energy lists, on the host in one read (counted in ``host_syncs``); an
accepted move rebuilds the pair cache, drops the VV force carry and zeroes
``pos_err``.  k vectors, the nowrap frame's budget and the dispersion
correction are computed from the box at every call.  Energy queries (the
attempt's two, ``potential_energy_terms``, ``get_forces``) go through
``Context._energy_query``: a flagged energy list (a lattice start pulled a
whole shell of tile pairs inside the candidate radius, or a nowrap frame
no longer fits the scaled box) repeats the query, or the attempt with the
same draws, on the full list
(``ForceEvaluator.energy_forces(full_list=True)``).

On a mesh (``mesh=``, from ``parallel.mesh.make_mesh``) each rank holds
the whole State and runs this same loop; the pair sweep is split over the
ranks' row tiles (``ForceEvaluator``'s mesh route, one all_reduce a force
evaluation).  As in the JAX package the system is padded with inert ghosts
to a multiple of the mesh size (``system.pad_system``), hidden from
``get_positions`` / ``get_velocities`` and the setters, and the mirror
route is off.  Every decision that steers the loop comes out the same on
every rank: the coverage flag rides in the sweep's all_reduce, the energy
queries' host reads (the barostat's accept flag) are rank 0's, broadcast,
and at construction, at every pair-cache rebuild and before every barostat
attempt the State is rank 0's (``parallel.mesh.shard_carry``), so the
ranks' caches and Langevin and barostat draws are the same.
"""
from __future__ import annotations

import sys
from typing import Sequence

import numpy as np
import torch

from .forces import ForceEvaluator
from .integrators import barostat as baro_mod
from .integrators import stepping
from .integrators.vv import IntegratorData, VVIntegrator
from .ops import constraints as cons_mod
from .parallel.mesh import shard_carry, sharded_step
from . import step_graph
from .system import State, System, make_state, pad_system, resolve_device
from . import trace
from .units import BOLTZ


def image_mirror(data: IntegratorData, charges):
    """(img0, par0, count, mirror_z) when the image pairs are a contiguous
    trailing block of images, in order, whose parents are the block just
    before it, with each image's charge exactly the negated parent's; else
    None (the explicit evaluation over all atoms)."""
    ip = np.asarray(data.image_pairs)
    if not ip.shape[0]:
        return None
    k, n = ip.shape[0], np.asarray(charges).shape[0]
    img0, par0 = int(ip[0, 0]), int(ip[0, 1])
    q = np.asarray(charges)
    if (par0 + k == img0 and img0 + k == n
            and np.array_equal(ip[:, 0], np.arange(img0, n))
            and np.array_equal(ip[:, 1], np.arange(par0, img0))
            and np.array_equal(q[img0:], -q[par0:img0])):
        return (img0, par0, k, float(data.mirror_location))
    return None


class Context:
    def __init__(self, system: System, integrator: VVIntegrator,
                 external_forces: Sequence = (), barostat=None,
                 positions=None, box=None, ewald_chunk: int | None = None,
                 sort_refresh: int = 120, pair_ts: int = 0,
                 fold_exc14: bool = False, recip: str = "exact", mesh=None,
                 strict_pairs: bool = False, pair_kernel: str = "plist",
                 cuda_graph: bool = False, device="cuda"):
        """On a mesh the context runs on the mesh's device, which
        ``device`` must name in kind ("cpu" for a host mesh).
        ``cuda_graph`` replays each step from a CUDA graph (module doc);
        a Context that cannot raises ValueError."""
        with trace.span("context.init"):
            if box is None:
                raise ValueError("box is required")
            self.mesh = mesh
            self.n_real = system.n_atoms
            self.device = resolve_device(device)
            if mesh is not None:
                if self.device.type != mesh.device.type:
                    raise ValueError(f"device {device!r} is not the mesh's "
                                     f"{mesh.device}")
                self.device = mesh.device
                n_pad = -(-system.n_atoms // mesh.size) * mesh.size
                system = pad_system(system, n_pad)
                if positions is not None:
                    positions = self._pad(positions, n_pad)
            if self.device.type == "cuda":
                # the reciprocal contraction must stay in full float32
                torch.backends.cuda.matmul.allow_tf32 = False
            self.system = system
            self.integrator = integrator
            self.data: IntegratorData = integrator.build_data(system)
            self.sort_refresh = int(sort_refresh)
            box = np.asarray(box, np.float32)
            # no mirror route on a mesh, as in the JAX package
            self.image_mirror = (image_mirror(self.data, system.charges)
                                 if mesh is None else None)
            self.evaluator = ForceEvaluator(
                system, external_forces, ewald_chunk=ewald_chunk,
                pair_ts=pair_ts, fold_exc14=fold_exc14,
                recip=recip, box_hint=box, pos_hint=positions, mesh=mesh,
                strict_pairs=strict_pairs, pair_kernel=pair_kernel,
                image_mirror=self.image_mirror, device=self.device)
            self.cons = cons_mod.build_constraint_data(
                np.asarray(system.constraints),
                np.asarray(system.constraint_dist),
                np.asarray(system.inv_masses),
                tolerance=integrator.constraint_tolerance, device=self.device)
            n = system.n_atoms
            self.state: State = make_state(
                np.zeros((n, 3), np.float32) if positions is None
                else positions,
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
            dev = self.device
            self._thermo = stepping.thermostat_tables(system, data, dev)
            self._hardwall = stepping.hardwall_tables(system, data, dev)
            self._langevin = stepping.langevin_tables(system, data, dev)
            # the E-field force is a constant (N,3) table, a virtual site's
            # share on its parents; none without a field
            self._efield = None
            if data.electrolyte.shape[0] and data.electric_field != 0:
                fz = stepping.vsite_field_to_parents(
                    stepping.efield_extra_force(np.asarray(system.charges),
                                                data), system)
                self._efield = torch.as_tensor(
                    fz[:, None] * np.asarray([0.0, 0.0, 1.0], np.float32),
                    device=self.device)
            self._ex = torch.tensor([1.0, 0.0, 0.0], device=self.device)
            self._images = (torch.as_tensor(
                np.asarray(data.image_pairs, np.int64), device=self.device)
                if data.image_pairs.shape[0] else None)
            # an image of a virtual site mirrors the site's placement: the
            # step never moves a massless site's stored row
            self._image_sites = stepping.image_site_tables(
                system, data.image_pairs, self.device)
            self.barostat = barostat
            if barostat is not None:
                self._baro_mol = baro_mod.molecule_tables(system, self.device)
                self.baro_state = baro_mod.make_barostat_state(
                    float(np.prod(box.astype(np.float64))), self.device)
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
            # values (those of step() and of the energy queries)
            self.rebuilds = 0
            self.coverage_rebuilds = 0
            self.refits = 0
            self.host_syncs = 0
            # the barostat's attempts and acceptances since construction
            self.baro_attempts = 0
            self.baro_accepts = 0
            # the captured step (step_graph.StepGraph), made at the first
            # segment
            self.cuda_graph = bool(cuda_graph)
            self._graph = None
            if self.cuda_graph:
                why = step_graph.blocker(self)
                if why is not None:
                    raise ValueError(f"cuda_graph: {why}")
            if positions is not None:
                self.set_positions(positions)
            self._sync()

    # --------------------------------------------------------- public API
    @staticmethod
    def _pad(arr, n):
        """An (m, 3) user array as float32 numpy, zero rows appended up to
        ``n`` (the mesh-padding ghosts)."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu()
        arr = np.asarray(arr, np.float32)
        return np.concatenate([arr, np.zeros((n - arr.shape[0],)
                                             + arr.shape[1:], np.float32)])

    def _tensor(self, arr):
        """A user (n_real, 3) array on the device, over the ghosts too."""
        if len(arr) == self.n_real < self.system.n_atoms:
            arr = self._pad(arr, self.system.n_atoms)
        if isinstance(arr, torch.Tensor):
            return arr.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(arr, np.float32),
                               device=self.device)

    def _sync(self):
        """On a mesh, rank 0's State on every rank."""
        if self.mesh is not None:
            self.state = shard_carry(self.state, self.mesh)

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
        """Positions with virtual sites re-placed in their parent frames
        (mesh-padding ghosts excluded)."""
        return self.evaluator.place_vsites(
            self.state.pos).cpu().numpy()[:self.n_real]

    def get_velocities(self):
        return self.state.vel.cpu().numpy()[:self.n_real]

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

    def _energy_query(self, query):
        """The one rule of the energy queries, which build their own pair
        list: ``query(full_list)`` evaluates through
        ``ForceEvaluator.energy_forces(..., return_cov=True,
        full_list=full_list)`` and returns (result, reads), device scalars
        for the host whose last is the OR of its lists' flags.  The reads
        come to the host in one read (counted in ``host_syncs``); where a
        list came back flagged (overflow, or a nowrap frame that no longer
        fits) it missed pairs, and the query is repeated on the full list,
        which cannot be flagged.  Returns (result, the values read before
        the flag).  A sweep whose query flag is never set
        (``query_flag`` False) has its flag dropped unread."""
        flagged = self.evaluator.pairs.query_flag
        with trace.span("energy.query"):
            for full in (False, True):
                result, reads = query(full)
                reads = reads if flagged else reads[:-1]
                values = []
                if reads:
                    flags = torch.stack([torch.as_tensor(
                        r, dtype=torch.uint8, device=self.device)
                        for r in reads])
                    if self.mesh is not None:
                        self.mesh.broadcast(flags)
                    values = [bool(v) for v in flags.tolist()]
                    self.host_syncs += 1
                if not flagged:
                    return result, values
                if not values[-1]:
                    return result, values[:-1]
        raise RuntimeError("the full energy list came back flagged")

    def _energy_forces(self, pos, box):
        """(terms, forces) of an energy query (device tensors)."""
        def query(full):
            terms, f, bad = self.evaluator.energy_forces(
                pos, box, return_cov=True, full_list=full)
            return (terms, f), [bad]
        return self._energy_query(query)[0]

    def potential_energy_terms(self):
        terms, _ = self._energy_forces(self.state.pos, self.state.box)
        return {k: float(v) for k, v in terms.items()}

    def potential_energy(self):
        return sum(self.potential_energy_terms().values())

    def group_energies(self):
        return {g: float(v) for g, v in self.evaluator.group_energies(
            self.potential_energy_terms()).items()}

    def get_forces(self):
        _, f = self._energy_forces(self.state.pos, self.state.box)
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
        """A pair cache for the current positions, from the sweep's
        rebuild, which reports its builds, host reads and refits (a pair
        list that came back flagged is refitted and built again)."""
        with trace.span("loop.rebuild"):
            self._sync()
            ev, st = self.evaluator, self.state
            cache, builds, reads, notes = ev.pairs.rebuild(
                ev.place_vsites(st.pos), st.box)
            self.rebuilds += builds
            self.host_syncs += reads
            self.refits += len(notes)
            for note in notes:
                print(f"[vv-torch] pair list refit after a flagged rebuild: "
                      f"{note}", file=sys.stderr)
            return cache

    @torch.no_grad()
    def step(self, n: int):
        """Advance ``n`` steps of the integrator's scheme in cache segments
        (see the module doc)."""
        cached = self.evaluator.pairs.carries_cache
        one_step = self._step_middle if self.data.use_middle else \
            self._step_vv
        if self.mesh is not None:
            one_step = sharded_step(one_step, self.mesh)
        n = int(n)
        done = 0
        baro = self.barostat
        graph = None
        while done < n:
            with trace.span("loop.segment"):
                cache = self._fresh_cache() if cached else None
                if self.cuda_graph:
                    graph = self._step_graph(cache)
                lim = min(done + self.sort_refresh, n)
                while done < lim:
                    if baro is not None \
                            and self.state.step % baro.frequency == 0 \
                            and self._barostat_attempt() and cached:
                        cache = self._fresh_cache()
                    with trace.span("step", self.state.step):
                        cov = (one_step(cache) if graph is None
                               else graph.replay(self))
                    done += 1
                    if cached:
                        # a sweep with host_flag has read the flag already,
                        # before the kick, and cov is a Python bool
                        self.host_syncs += 1
                        with trace.span("loop.flag_read"):
                            tripped = bool(cov)
                    if graph is not None:
                        graph.timed()
                    if cached and tripped:
                        self.coverage_rebuilds += 1
                        break
        if graph is not None:
            graph.release(self)

    def _step_graph(self, cache):
        """The captured step, loaded with the State and ``cache``; captured
        anew where the last capture does not fit them."""
        if self._graph is None or not self._graph.fits(self, cache):
            self._graph = None
            self._graph = step_graph.StepGraph(self, cache)
        self._graph.load(self, cache)
        return self._graph

    def _barostat_draws(self):
        return baro_mod.draw(self.barostat.kind, self.state.generator,
                             self.device)

    def _barostat_attempt(self) -> bool:
        """One MC volume attempt (the JAX ``update_context_state``); returns
        whether it was accepted.  The accept flag and the energy lists'
        flags come to the host in one read; a flagged list repeats the
        attempt, with the same draws, on the full list."""
        with trace.span("baro.attempt"):
            self._sync()
            st, ev = self.state, self.evaluator
            draws = self._barostat_draws()

            def query(full):
                flags = []

                def energy(pos, box):
                    terms, _, bad = ev.energy_forces(pos, box, return_cov=True,
                                                     full_list=full)
                    flags.append(torch.as_tensor(bad, device=self.device))
                    return sum(terms.values())
                move = baro_mod.attempt_move(self.barostat, self.baro_state,
                                             st.pos, st.box, self._baro_mol,
                                             energy, draws)
                return move, [move[0], flags[0] | flags[1]]
            (_, pos, box, bst, _), (accepted,) = self._energy_query(query)
            self.baro_state = bst
            self.baro_attempts += 1
            if accepted:
                self.baro_accepts += 1
                self.state = st.replace(pos=pos, box=box,
                                        pos_err=torch.zeros_like(st.pos_err))
                self._forces_valid = False
            return accepted

    def _sync_images(self, new_pos, new_err):
        """Images onto their parents' mirror, a virtual site's as placed;
        ``pos_err`` zeroed on every row the sync moved."""
        if self._images is None:
            return new_pos, new_err
        with trace.span("step.images"):
            parents = None
            if self._image_sites is not None:
                rows, par, w = self._image_sites
                parents = new_pos.index_put((rows,), torch.einsum(
                    "vp,vpx->vx", w, new_pos[par]))
            img_pos = stepping.update_image_positions(
                new_pos, self._images, self.data.mirror_location, parents)
            moved = (img_pos != new_pos).any(-1, keepdim=True)
            return img_pos, torch.where(moved, torch.zeros_like(new_err),
                                        new_err)

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
        with trace.span("step.thermostat"):
            cos_v = st.cos_v
            has_cos = self.data.cos_acceleration != 0
            if has_cos:
                cos_v = stepping.cos_velocity_bias(pos, vel, self._masses,
                                                   box)
                vel = stepping.cos_shift_velocity(pos, vel, box, cos_v, -1.0)
            vel, eta, eta_dot, eta_dotdot, _ = stepping.nh_scale_velocities(
                vel, self.data, self._thermo, st.nh_eta, st.nh_eta_dot,
                st.nh_eta_dotdot)
            if has_cos:
                vel = stepping.cos_shift_velocity(pos, vel, box, cos_v, 1.0)
            return vel, st.replace(nh_eta=eta, nh_eta_dot=eta_dot,
                                   nh_eta_dotdot=eta_dotdot, cos_v=cos_v)

    def _step_forces(self, pos, vel, box, cache, ld_as_force):
        """The step's force evaluation at ``pos``: (forces, extra forces,
        coverage flag).  The extra forces are None where the system has
        none, or where ``ld_as_force`` is None (the VV scheme's evaluation
        with an invalid carry, which kicks with the carried ones)."""
        with trace.span("step.forces"):
            _, F, cov = self.evaluator.energy_forces(
                pos, box, want_energy=False, pair_cache=cache,
                return_cov=True)
            Fx = (self._extra_forces(pos, vel, box, ld_as_force)
                  if self._has_extra and ld_as_force is not None else None)
        return F, Fx, cov

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
        # Langevin runs as the exact OU map below, not as a force
        F, Fx, cov = self._step_forces(pos, vel, box, cache,
                                       ld_as_force=False)
        if Fx is not None:
            F = F + Fx
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
            with trace.span("step.langevin"):
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
        new_pos, new_err = self._sync_images(new_pos, new_err)
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
        data, cons, st = self.data, self.cons, self.state
        has_cons = cons.n_constraints > 0
        has_nh = data.nh_normal.shape[0] + data.nh_pairs.shape[0] > 0
        vel = self._remove_cm_motion(st.vel)
        pos, err, box = st.pos, st.pos_err, st.box
        if self._forces_valid:
            F = self._forces
        else:
            F, _, _ = self._step_forces(pos, vel, box, cache, None)
            if self.evaluator.pairs.host_flag:
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
        new_pos, new_err = self._sync_images(new_pos, new_err)
        F2, Fx2, cov = self._step_forces(new_pos, vel, box, cache,
                                         ld_as_force=True)
        if Fx2 is None:
            Fx2 = torch.zeros_like(F2)
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
