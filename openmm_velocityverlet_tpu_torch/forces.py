"""Total potential-energy / force evaluation (counterpart of
``openmm_velocityverlet_tpu/forces.py``).

Composes the direct-space pair sweep with the residual exclusion
adjustment; the reciprocal (exact-k Ewald or PME), CMAP, NBTHOLE, implicit
solvent (GB) and the Tang-Toennies damping, with forces by
``torch.autograd.grad``; the bonded, Drude, Thole and 1-4
exception terms with analytic forces (``mol_terms`` and ``term_forces``);
the Ewald self and LJ long-range corrections; external energy closures
(``ops/external.py``: autograd forces, or their own ``analytic_force``);
and virtual-site force redistribution.

The direct-space sweep is an object, ``self.pairs``, which
``pair_sweep`` chooses once, at construction, and nothing else tests the
mode: ``pair_plist.PlistSweep``, the tile-pair list of kernel B1 (the
default); ``pair_tri.BandSweep``, the z-banded upper-triangle sweep of
kernel B2, selected by ``fold_exc14=True`` as in the JAX package, with
regular 1-4 exceptions folded into the kernel, and on a mesh its split
form; ``allpairs.DenseSweep``, the all-pairs torch sweep
(``pair_kernel="dense"``).  Each owns its plan (fixed from ``pos_hint`` /
``box_hint`` by its cost model), its cache rebuild, which ``Context``
calls, and its call, which ``energy_forces`` makes; and it answers, as
values, whether the step carries a cache (``carries_cache``), whether an
energy query's flag can be set (``query_flag``) and whether the step's
flag comes back read on the host (``host_flag``).  ``strict_pairs=True``
takes kernel B2's exhaustive sweep on a step whose coverage check trips.
Reciprocal: ``recip="exact"`` (matrix products, the
gradient in closed form beside the energy; the port's default; its atom
chunk, 0 unless the phase block would crowd the device's free memory, is
fixed at construction by ``ewald.chunk_rows`` unless ``ewald_chunk`` gives
one), ``"exact_fused"`` (kernels B4/B5), ``"pme"``
(``ops/pme.py``, torch scatter and FFT, autograd; its grid is chosen from
``box_hint`` at construction and stays while a barostat scales the box) or
``"auto"`` (``pme.choose_reciprocal``'s cost model of the routes on the
card).  ``image_mirror`` (from ``Context``'s detection of the
constant-voltage layout) takes the matmul route over the real atoms only
(``ewald.reciprocal_energy(mirror=)``); the fused and PME routes run all
atoms, images included, as in the JAX package.  On a CPU tensor every
kernel wrapper takes its plain torch version.

Energy queries (no pair cache given) build their own list, which keeps the
tile pairs of force-inert atoms (image charges) that the step's list culls;
its capacity ``PlistSweep.cap_all`` is sized without that cull.  With
``full_list=True`` that list has every tile pair's capacity and no nowrap
frame, a list that cannot be flagged: ``Context._energy_query`` repeats a
query whose list came back flagged that way.

On a mesh (``parallel/mesh.py``, the JAX rules of forces.py:140-142 and
302-309) the sweep is the band's split form
(``pair_tri.banded_sweep_sharded``): each rank runs kernel B2 over its share
of the row tiles and one all_reduce sums the forces, the pair energies and
the coverage flag.  The band cache is padded to a multiple of the mesh
size in tiles, ``exact_fused`` becomes ``exact``, and a coverage trip
never takes the full sweep (``strict_pairs`` is ignored): the flagged step
runs on the stale cache and the next one on a rebuilt cache.  A system
whose band is not eligible (too few tiles for its width) is refused at
construction.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .ops import (allpairs, cmap, ewald, ewald_fused, gb, mol_terms,
                  nonbonded, pair_plist, pair_tri, pme, term_forces, vsites)
from . import trace
from .system import System, resolve_device


def pair_sweep(system, tables, device, *, pair_kernel, fold_exc14, mesh,
               strict, ts, pos, box):
    """The direct-space sweep for these options, its plan chosen from the
    configuration ``pos`` in ``box`` (host arrays, or None): the one place
    the pair mode is chosen, by the JAX rule (forces.py:139-142).  The z
    band carries kernel-folded 1-4 exceptions and the mesh's split sweep;
    the tile-pair list does neither."""
    if pair_kernel not in ("plist", "dense"):
        raise ValueError(
            f"pair_kernel={pair_kernel!r}: the port's pair kernels are "
            "'plist' and 'dense'; the z-band sweep is selected with "
            "fold_exc14=True")
    if pair_kernel == "dense":
        if mesh is not None:
            raise ValueError("a mesh splits kernel B2's band sweep; the "
                             "dense sweep has no split form")
        return allpairs.DenseSweep(system, tables, device)
    if fold_exc14 or mesh is not None:
        return pair_tri.BandSweep.plan(system, tables, device, pos, box, ts,
                                       strict, mesh)
    return pair_plist.PlistSweep.plan(system, tables, device, pos, box, ts,
                                      strict)


def _drop_constraint_null_terms(system):
    """System copy with constraint-null spring terms removed, or None if
    there are none.

    A bond/Urey-Bradley spring on a constrained pair, or an angle spring
    whose three internal distances are all constrained (rigid water), acts
    only along directions the constraint solver projects away: SHAKE holds
    the coordinate fixed and RATTLE removes the along-constraint velocity
    component after every kick, so dropping the term from the FORCE path is
    exactly equivalent dynamics.  These terms exist because the reference
    defaults to flexibleConstraints=True (oplspsffile.py:1000-1008), which
    is about reported energies, not dynamics — energy queries keep them."""
    cons = np.asarray(system.constraints)
    if cons.shape[0] == 0:
        return None
    cset = {(int(min(i, j)), int(max(i, j))) for i, j in cons.tolist()}

    def pair_null(tbl):
        t = np.asarray(tbl).reshape(-1, 2)
        return np.array([(min(i, j), max(i, j)) in cset
                         for i, j in t.tolist()], bool)

    null_b = pair_null(system.bonds) if system.bonds.shape[0] else \
        np.zeros(0, bool)
    null_u = pair_null(system.ub_bonds) if system.ub_bonds.shape[0] else \
        np.zeros(0, bool)
    ang = np.asarray(system.angles).reshape(-1, 3)
    null_a = np.array(
        [((min(i, j), max(i, j)) in cset and (min(j, k), max(j, k)) in cset
          and (min(i, k), max(i, k)) in cset) for i, j, k in ang.tolist()],
        bool) if ang.shape[0] else np.zeros(0, bool)
    if not (null_b.any() or null_u.any() or null_a.any()):
        return None
    kb, ku, ka = ~null_b, ~null_u, ~null_a
    return system.replace(
        bonds=np.asarray(system.bonds).reshape(-1, 2)[kb],
        bond_r0=np.asarray(system.bond_r0)[kb],
        bond_k=np.asarray(system.bond_k)[kb],
        ub_bonds=np.asarray(system.ub_bonds).reshape(-1, 2)[ku],
        ub_r0=np.asarray(system.ub_r0)[ku],
        ub_k=np.asarray(system.ub_k)[ku],
        angles=ang[ka],
        angle_theta0=np.asarray(system.angle_theta0)[ka],
        angle_k=np.asarray(system.angle_k)[ka])


class ForceEvaluator:
    """``energy_forces(pos, box) -> (terms, forces)`` for one System on one
    device.  Static tables are uploaded once, at construction."""

    def __init__(self, system: System,
                 external_forces: Sequence[Callable] = (),
                 ewald_chunk: int | None = None, pair_kernel: str = "plist",
                 box_hint=None, pos_hint=None, pair_ts: int = 0,
                 fold_exc14: bool = False, recip: str = "exact", mesh=None,
                 strict_pairs: bool = False, image_mirror=None,
                 device="cuda"):
        if recip not in ("exact", "exact_fused", "pme", "auto"):
            raise ValueError(
                f"recip={recip!r}: the reciprocal routes are 'exact', "
                "'exact_fused', 'pme' and 'auto'")
        self.system = system
        self.device = resolve_device(device)
        self.external_forces = list(external_forces)
        self._analytic_externals = [
            (i, f) for i, f in enumerate(self.external_forces)
            if getattr(f, "analytic_force", None) is not None]
        # (img0, par0, count, mirror_z) of a contiguous trailing image block
        # mirroring the block just before it (Context checks the layout)
        self.image_mirror = image_mirror
        # the JAX choice of reciprocal (forces.py:289-310): "auto" by the
        # cost model, PME on a grid fixed from box_hint
        self.pme_grid = None
        if recip == "auto":
            recip = "exact"
            if box_hint is not None and system.ewald_beta > 0:
                recip, _ = pme.choose_reciprocal(
                    system.n_atoms, system.kmax, np.asarray(box_hint))
        if recip == "pme":
            if box_hint is None:
                raise ValueError("recip='pme' requires box_hint")
            self.pme_grid = pme.choose_grid(np.asarray(box_hint))
        if recip == "exact_fused" and mesh is not None:
            # kernels B4/B5 have no split form; the matmul route replicates
            recip = "exact"
        self.recip_method = recip
        dev = self.device
        # the matmul route's atom chunk, fixed here from the shapes: the
        # real atoms' phase block against the device's free memory
        self.ewald_chunk = 0
        if recip == "exact" and system.ewald_beta > 0:
            self.ewald_chunk = (ewald.chunk_rows(
                system.n_atoms if image_mirror is None else image_mirror[0],
                system.kmax, ewald.free_bytes(dev))
                if ewald_chunk is None else int(ewald_chunk))
        self.t = system.to(dev)
        # the NBTHOLE sweep's tables and the GB parameters, on the device
        # once (the JAX package rebuilds the former at every trace)
        self.nbthole = nonbonded.nbthole_tables(
            system.nbt_idx, system.nbt_alpha, system.nbt_coef,
            system.charges, system.exclusions, dev)
        self.gb = None if system.gb is None else system.gb.to(dev)
        self.pair_tables = allpairs.build_pair_tables(
            system.n_atoms, system.lj_type, system.acoef, system.bcoef,
            system.exclusions, system.lj_group, system.lj_group_allowed,
            exc_idx=system.exc_idx, exc_qq=system.exc_qq,
            exc_c6=system.exc_c6, exc_c12=system.exc_c12,
            charges=system.charges, fold_exc14=fold_exc14)
        if self.pair_tables["residual"].shape[0]:
            self.pair_tables["residual_dev"] = allpairs.residual_tensors(
                self.pair_tables, dev)
        # the direct-space sweep, its plan fixed from the hints
        self.pairs = pair_sweep(
            system, self.pair_tables, dev, pair_kernel=pair_kernel,
            fold_exc14=fold_exc14, mesh=mesh, strict=strict_pairs,
            ts=pair_ts, pos=pos_hint, box=box_hint)

        def build_term_eval(sysm):
            exc_mask = self.pair_tables["exc_term_mask"]
            mt, leftover = mol_terms.build_mol_tables(sysm, exc_mask=exc_mask)
            if len(mt) > 32:
                mt = []
                leftover = None
            if leftover is not None and "exception" in leftover:
                exc_mask = leftover.pop("exception")
            terms, inc, _ = term_forces.build_term_tables(
                sysm, exc_keep_mask=exc_mask, keep_masks=leftover)
            return (mol_terms.types_to(mt, dev),
                    term_forces.tables_to(terms, inc, dev))

        self.mol_types, self.term_tables = build_term_eval(system)
        # force path without constraint-null springs (see
        # _drop_constraint_null_terms); energy queries keep the full tables
        fsys = _drop_constraint_null_terms(system)
        self.mol_types_force, self.term_tables_force = (
            (self.mol_types, self.term_tables) if fsys is None
            else build_term_eval(fsys))

    # -- virtual sites ----------------------------------------------------
    def place_vsites(self, pos):
        t = self.t
        return vsites.compute_vsites(pos, t.vsite_index, t.vsite_parents,
                                     t.vsite_origin_w, t.vsite_x_w,
                                     t.vsite_y_w, t.vsite_local)

    # -- gradient terms ----------------------------------------------------
    def smooth_terms(self, box):
        """The terms whose force comes from autograd: the reciprocal, CMAP,
        NBTHOLE, GB, the TT damping and the external closures without an
        ``analytic_force``, each as a function of the placed positions:
        {name: pos -> energy}."""
        s, t = self.system, self.t
        terms = {}
        if s.ewald_beta > 0 and self.recip_method == "pme":
            # over all atoms, images included (JAX forces.py:377-380)
            terms["coul_recip"] = lambda pos: pme.reciprocal_energy_pme(
                pos, box, t.charges, s.ewald_beta, self.pme_grid)
        elif s.ewald_beta > 0 and self.recip_method == "exact_fused":
            # kernels B4 (forward) and B5 (backward): nothing of size
            # (N, K) is stored
            terms["coul_recip"] = lambda pos: \
                ewald_fused.reciprocal_energy_fused(
                    pos, box, t.charges, s.ewald_beta, s.kmax, 256)
        elif s.ewald_beta > 0:
            terms["coul_recip"] = lambda pos: ewald.reciprocal_energy(
                pos, box, t.charges, s.ewald_beta, s.kmax,
                chunk=self.ewald_chunk, mirror=self.image_mirror)
        if s.cmap_atoms.shape[0] > 0:
            terms["cmap"] = lambda pos: cmap.cmap_energy(
                pos, box, t.cmap_atoms, t.cmap_map, t.cmap_coeffs,
                t.cmap_res)
        if self.nbthole is not None:
            # the reference truncates NBTHOLE at a hard-coded 0.5 nm
            # (oplspsffile.py:1407), not at the system cutoff
            terms["nbthole"] = lambda pos: nonbonded.nbthole_energy(
                pos, box, self.nbthole, min(0.5, s.r_cutoff))
        if self.gb is not None:
            # all pairs, no bonded exclusions, no periodic images
            terms["gb"] = lambda pos: gb.gb_energy(pos, t.charges, self.gb)
        if s.tt_donors.shape[0] > 0:
            terms["tt_damping"] = lambda pos: nonbonded.tt_damping_energy(
                pos, box, t.tt_donors, t.tt_charges, t.tt_dipole_mask,
                t.exclusions, float(s.tt_b), float(s.tt_cutoff))
        for i, f in enumerate(self.external_forces):
            if getattr(f, "analytic_force", None) is None:
                terms[f"external_{i}"] = lambda pos, f=f: f(pos, box)
        return terms

    # -- full evaluation --------------------------------------------------
    @torch.no_grad()
    def energy_forces(self, pos_raw, box, want_energy: bool = True,
                      pair_cache=None, return_cov: bool = False,
                      full_list: bool = False):
        """Returns (terms dict, forces on real dofs), plus the pair
        coverage flag when ``return_cov``: a device bool, or a Python bool
        where the sweep has read it on the host already
        (``self.pairs.host_flag``).  With ``want_energy=False`` the pair
        kernel takes its force-only specialization and the
        constraint-null springs are skipped.  Without ``pair_cache`` the
        plist sweep builds a list that culls nothing, and its flag says
        whether that list overflowed or its nowrap frame failed (then its
        energies miss pairs); with ``full_list`` that list holds every tile
        pair's place and takes the wrapped frame, so it is never
        flagged."""
        s, t = self.system, self.t
        with trace.span("forces.vsites"):
            pos = self.place_vsites(pos_raw)
        with trace.span("forces.pairs"):
            e_lj, e_coul_dir, e_corr, e14c, e14l, f_direct, cov = \
                self.pairs(pos, box, pair_cache, want_energy, full_list)

        with trace.span("forces.smooth"), torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            terms = {k: fn(p)
                     for k, fn in self.smooth_terms(box).items()}
            if terms:
                e_smooth = sum(terms.values())
                (grad_smooth,) = torch.autograd.grad(e_smooth, p)
            else:
                grad_smooth = torch.zeros_like(pos)
        terms = {k: v.detach() for k, v in terms.items()}
        with trace.span("forces.terms"):
            t_terms, t_inc = (self.term_tables if want_energy
                              else self.term_tables_force)
            mol_types = self.mol_types if want_energy else self.mol_types_force
            term_energies, f_terms = term_forces.energies_and_forces(
                pos, box, t_terms, t_inc)
            if mol_types:
                mol_energies, f_mol = mol_terms.energies_and_forces(
                    pos, box, mol_types, s.n_atoms)
                f_terms = f_terms + f_mol
                for k, v in mol_energies.items():
                    term_energies[k] = term_energies.get(k, 0.0) + v
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        for name in ("bond", "angle", "urey_bradley", "dihedral", "improper",
                     "drude", "thole", "exception_coul", "exception_lj"):
            terms[name] = term_energies.get(name, zero)
        terms["exception_coul"] = terms["exception_coul"] + e14c
        terms["exception_lj"] = terms["exception_lj"] + e14l
        terms["lj"] = e_lj
        terms["coul_direct"] = e_coul_dir
        terms["coul_excl_corr"] = e_corr
        if s.ewald_beta > 0:
            terms["coul_self"] = nonbonded.ewald_self_energy(
                t.charges, s.ewald_beta, box)
        if s.use_dispersion_correction:
            terms["lj_lrc"] = nonbonded.dispersion_correction(
                box, s.disp_coef_a2, s.disp_coef_b, s.r_cutoff,
                r_switch=s.r_switch)
        forces = f_direct + f_terms - grad_smooth
        # externals with their own forces (masked elementwise over all N)
        if self._analytic_externals:
            with trace.span("forces.external"):
                for i, f in self._analytic_externals:
                    terms[f"external_{i}"] = f(pos, box)
                    forces = forces + f.analytic_force(pos, box)
        with trace.span("forces.vsites"):
            forces = vsites.redistribute_forces(
                pos_raw, forces, t.vsite_index, t.vsite_parents,
                t.vsite_origin_w, t.vsite_x_w, t.vsite_y_w, t.vsite_local)
        if return_cov:
            return terms, forces, cov
        return terms, forces

    def potential_energy(self, pos_raw, box):
        terms, _ = self.energy_forces(pos_raw, box)
        return sum(terms.values()), terms

    # Force-group decomposition mirroring oplspsffile.py:169-177 + force.py
    GROUP_MAP = {
        1: ("bond",),
        2: ("angle", "urey_bradley"),
        3: ("dihedral",),
        4: ("improper",),
        5: ("lj", "coul_direct", "coul_recip", "coul_self", "coul_excl_corr",
            "exception_coul", "exception_lj", "lj_lrc", "nbthole"),
        7: ("drude", "thole"),
        9: ("tt_damping",),
    }

    def group_energies(self, terms):
        out = {}
        for g, keys in self.GROUP_MAP.items():
            vals = [terms[k] for k in keys if k in terms]
            if vals:
                out[g] = sum(vals)
        ext = [v for k, v in terms.items() if k.startswith("external_")]
        if ext:
            out[0] = sum(ext)
        return out
