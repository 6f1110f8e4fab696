"""Total potential-energy / force evaluation (counterpart of
``openmm_velocityverlet_tpu/forces.py``).

Composes the direct-space pair sweep with the residual exclusion
adjustment; the exact-k Ewald reciprocal and the Tang-Toennies damping,
with forces by ``torch.autograd.grad``; the bonded, Drude, Thole and 1-4
exception terms with analytic forces (``mol_terms`` and ``term_forces``);
the Ewald self and LJ long-range corrections; and virtual-site force
redistribution.

Pair sweeps (``pair_mode``): "plist", the tile-pair list of kernel B1 (the
default); "band", the z-banded upper-triangle sweep of kernel B2, selected
by ``fold_exc14=True`` as in the JAX package, with regular 1-4 exceptions
folded into the kernel; "dense", the all-pairs torch sweep.
``strict_pairs=True`` takes kernel B2's exhaustive sweep on a step whose
coverage check trips.  Reciprocal: ``recip="exact"`` (one matrix product,
autograd) or ``"exact_fused"`` (kernels B4/B5).  On a CPU tensor every
kernel wrapper takes its plain torch version.

Not ported yet, and refused with NotImplementedError: the mesh, PME,
NBTHOLE, CMAP, GB and external forces.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .ops import (allpairs, ewald, ewald_fused, mol_terms, nonbonded,
                  pair_plist, pair_tri, term_forces, vsites)
from .system import System, resolve_device


# tile sizes the plist evaluator chooses from (kernel B1 takes any multiple
# of 32 up to 384 through ``pair_ts``), and the cost of one list slot (a row
# x column place of an entry's ts x ts) in pair evaluations: kernel B1 tests
# every 32 x 32 chunk of slots against the cutoff and evaluates only the
# columns in reach, and its device time at 19,500 atoms on an NVIDIA H100
# 80GB HBM3 (700 W) fits a x evaluations + b x slots + c with b / a as
# below (chip_smoke.py's tile-size sweep prints the fit)
PLIST_TILE_SIZES = (32, 64, 128, 256)
PLIST_SLOT_COST = 0.6
# tile sizes the band evaluator chooses from (kernel B2 takes any multiple of
# 32 up to 768 through ``pair_ts``), and the cost of one item it runs (a row
# chunk x column chunk of 32 x 32 atoms: a load, a vote and a partial
# written) in pair evaluations
BAND_TILE_SIZES = (256, 384, 512, 640, 768)
BAND_ITEM_COST = 200.0


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
                 ewald_chunk: int = 16384, row_block: int = 1024,
                 pair_kernel: str = "auto", box_hint=None, pos_hint=None,
                 pair_ts: int = 0, fold_exc14: bool = False,
                 recip: str = "exact", mesh=None,
                 strict_pairs: bool = False, device="cuda"):
        if external_forces:
            raise NotImplementedError(
                "external forces are not ported yet (ROADMAP A11)")
        if mesh is not None:
            raise NotImplementedError(
                "the multi-device mesh is not ported yet (ROADMAP A16)")
        if recip not in ("exact", "exact_fused"):
            raise NotImplementedError(
                f"recip={recip!r}: the port has the exact-k reciprocal "
                "('exact') and its fused kernels ('exact_fused'); PME is "
                "ROADMAP A13")
        if int(np.asarray(system.nbt_idx).max(initial=0)) > 0:
            raise NotImplementedError("NBTHOLE is not ported yet "
                                      "(ROADMAP A13)")
        if system.cmap_atoms.shape[0] > 0:
            raise NotImplementedError("CMAP is not ported yet (ROADMAP A13)")
        if system.gb is not None:
            raise NotImplementedError(
                "implicit solvent (GB) is not ported yet (ROADMAP A13)")
        if pair_kernel == "auto":
            pair_kernel = "plist"
        if pair_kernel not in ("plist", "dense"):
            raise ValueError(
                f"pair_kernel={pair_kernel!r}: the port's pair kernels are "
                "'plist' and 'dense'; the z-band sweep is selected with "
                "fold_exc14=True")
        self.system = system
        self.device = resolve_device(device)
        self.ewald_chunk = ewald_chunk
        self.row_block = row_block
        self.pair_kernel = pair_kernel
        # the z band carries kernel-folded 1-4 exceptions; the tile-pair
        # list does not (the JAX pair_mode choice, forces.py:139-142)
        self.pair_mode = ("dense" if pair_kernel == "dense"
                          else "band" if fold_exc14 else "plist")
        self.strict_pairs = bool(strict_pairs)
        self.recip_method = recip
        self.skin = 0.1
        dev = self.device
        self.t = system.to(dev)
        # force-inert particles (massless, not a virtual site): their
        # forces are discarded, so inert-inert tile pairs leave the force
        # path's pair list
        inert = np.asarray(system.inv_masses) == 0
        vidx = np.asarray(system.vsite_index).reshape(-1)
        if vidx.size:
            inert[vidx] = False
        self._inert_mask = inert if inert.any() else None
        rc_cand = system.r_cutoff + self.skin
        have_hint = pos_hint is not None and box_hint is not None
        # band_atoms: atoms inside any (cutoff + skin) z-window, from the
        # max z-local density of the initial configuration when available
        band_atoms = 0.0
        if box_hint is not None and system.n_atoms > 0:
            lz = float(np.asarray(box_hint).reshape(-1)[2])
            if pos_hint is not None:
                zw = np.asarray(pos_hint)[:, 2] % lz
                hist = np.histogram(zw, bins=np.arange(0.0, lz + 0.05,
                                                       0.05))[0]
                kwin = max(1, int(np.ceil(rc_cand / 0.05)))
                wrap = np.concatenate([hist, hist[:kwin]])
                band_atoms = float(np.convolve(
                    wrap, np.ones(kwin), mode="valid").max()) * 1.10
            else:
                band_atoms = rc_cand * (system.n_atoms / lz) * 1.08

        self.plist_sort = "morton"
        if pair_ts:
            self.pair_ts = int(pair_ts)
            if have_hint and self.pair_mode == "plist":
                cnts = {key: pair_plist.count_candidates_np(
                            pos_hint, box_hint, self.pair_ts, rc_cand,
                            mode=key, inert=self._inert_mask)
                        for key in ("z", "morton")}
                self.plist_sort = min(cnts, key=cnts.get)
        elif self.pair_mode == "band":
            # the tile size minimising kernel B2's cost on the initial
            # configuration: the pair evaluations left by its two skips (a
            # host-side model over the layout make_pair_cache would build)
            # plus BAND_ITEM_COST for every item it runs; without a
            # configuration, the banded sweep's pair count (the band width
            # quantises to whole tiles).  The TPU's candidates were 512,
            # 640 and 768: its tile was a grid step.
            costs = []
            for cand in BAND_TILE_SIZES:
                n_pad = -(-system.n_atoms // cand) * cand
                w = int(np.ceil(band_atoms / cand)) if band_atoms else 0
                eligible = w and pair_tri.band_eligible(n_pad, cand, w)
                if eligible and have_hint:
                    cost = self._band_cost(pos_hint, box_hint, cand, w)
                elif eligible:
                    cost = (n_pad // cand) * (w + 1) * cand * cand
                else:
                    cost = n_pad * n_pad // 2
                costs.append((cost, cand))
            # the largest tile within a tenth of the cheapest: a start
            # configuration is often a lattice, whose planes favour no size
            # by more than that, and once it has melted the thickest slab
            # makes the most compact chunks (on the card the 19,500-atom
            # liquid runs ts 768 a third faster than ts 512, which the
            # lattice start costs 7% cheaper)
            best = max((c for c in costs if c[0] <= 1.1 * min(costs)[0]),
                       key=lambda c: c[1])
            self.pair_ts = best[1]
        else:
            # jointly pick sort key and tile size minimising kernel B1's
            # cost on the initial configuration: the pair evaluations left
            # by its column skip (a host-side model of the skip over the
            # exact candidate enumeration) plus PLIST_SLOT_COST for every
            # slot of the list.  The constant was measured on the card, not
            # carried over from the TPU kernel's slots + 6000 an entry,
            # where a tile was a multiple of 128 lanes and an entry a grid
            # step.  Candidates go by ascending slot count, and one whose
            # slots alone cost more than the best so far is not modelled.
            best = (0, 32, "morton")
            if have_hint:
                slots = sorted(
                    (pair_plist.count_candidates_np(
                        pos_hint, box_hint, cand, rc_cand, mode=key,
                        inert=self._inert_mask) * cand * cand, cand, key)
                    for key in ("z", "morton") for cand in PLIST_TILE_SIZES)
                best = None
                for n_slots, cand, key in slots:
                    if best is not None \
                            and PLIST_SLOT_COST * n_slots >= best[0]:
                        break
                    cost = self._plist_cost(pos_hint, box_hint, cand, key)[0]
                    if best is None or cost < best[0]:
                        best = (cost, cand, key)
            self.pair_ts = best[1]
            self.plist_sort = best[2]
        self.band_w = (int(np.ceil(band_atoms / self.pair_ts))
                       if band_atoms else 0)
        # pair-list capacity: exact initial count x drift margin; and the
        # first-atom-frame ("nowrap") axes of the plist kernel, re-verified
        # per step by the coverage check
        self.plist_cap = 0
        self.plist_nowrap = (False, False, False)
        if self.pair_mode == "plist":
            n_tiles = -(-system.n_atoms // self.pair_ts)
            self.plist_cap = n_tiles * (n_tiles + 1) // 2
            if have_hint:
                cnt = pair_plist.count_candidates_np(
                    pos_hint, box_hint, self.pair_ts, rc_cand,
                    mode=self.plist_sort, inert=self._inert_mask)
                self.plist_cap = min(self.plist_cap, int(cnt * 1.6) + 64)
                self.plist_nowrap = pair_plist.nowrap_axes_np(
                    pos_hint, box_hint, self.pair_ts, rc_cand,
                    mode=self.plist_sort)
        self.pair_tables = allpairs.build_pair_tables(
            system.n_atoms, system.lj_type, system.acoef, system.bcoef,
            system.exclusions, system.lj_group, system.lj_group_allowed,
            exc_idx=system.exc_idx, exc_qq=system.exc_qq,
            exc_c6=system.exc_c6, exc_c12=system.exc_c12,
            charges=system.charges, fold_exc14=fold_exc14)
        if self.pair_tables["residual"].shape[0]:
            self.pair_tables["residual_dev"] = allpairs.residual_tensors(
                self.pair_tables, dev)
        self.statics = None
        if self.pair_mode == "plist":
            self.statics = pair_plist.padded_statics(
                system.charges, self.pair_tables, self.pair_ts, dev)
        elif self.pair_mode == "band":
            self.statics = pair_tri.band_statics(
                system.charges, self.pair_tables,
                pair_tri.padded_size(system.n_atoms, self.pair_ts), dev)

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

    @property
    def uses_band(self) -> bool:
        """True when the step carries a sorted pair cache: the plist list,
        or the z band when it is eligible (its enumeration covers every
        tile pair once)."""
        if self.pair_mode == "plist":
            return self.plist_cap > 0
        if self.pair_mode == "band":
            return pair_tri.band_eligible(
                pair_tri.padded_size(self.system.n_atoms, self.pair_ts),
                self.pair_ts, self.band_w)
        return False

    # -- virtual sites ----------------------------------------------------
    def place_vsites(self, pos):
        t = self.t
        return vsites.compute_vsites(pos, t.vsite_index, t.vsite_parents,
                                     t.vsite_origin_w, t.vsite_x_w,
                                     t.vsite_y_w, t.vsite_local)

    # -- spatial-sort cache -------------------------------------------------
    def make_pair_cache(self, pos_raw, box):
        """The sorted layout (and, in plist mode, the pair list) of the
        force path, rebuilt every sort_refresh steps and after a coverage
        trip."""
        if self.pair_mode == "band":
            return pair_tri.make_pair_cache(
                self.place_vsites(pos_raw), box, self.t.charges,
                self.pair_tables, self.pair_ts, statics=self.statics,
                inner_order=True)
        return pair_plist.make_pair_cache(
            self.place_vsites(pos_raw), box, self.system.charges,
            self.pair_tables, self.pair_ts, mode=self.plist_sort,
            cap=self.plist_cap, rc_cand=self.system.r_cutoff + self.skin,
            inert=self._inert_mask, nowrap=self.plist_nowrap,
            statics=self.statics)

    def _band_cost(self, pos, box, ts, band_w):
        """Cost of kernel B2's banded sweep at tile size ``ts`` on this
        configuration: the modelled pair evaluations after its skips plus
        BAND_ITEM_COST an item (marked chunk pairs left out: they are the
        same few at every tile size)."""
        pos = np.asarray(pos, np.float64)
        order = pair_tri.band_layout_np(pos, box, ts)
        n = pos.shape[0]
        real = order < n
        pos2d = np.concatenate([pos, np.full((order.shape[0] - n, 3),
                                             1e6)])[order]
        items, evals = pair_tri.skip_model_np(
            pos2d, real, box, None, ts, self.system.r_cutoff, band_w=band_w)
        return evals + BAND_ITEM_COST * items

    def _plist_cost(self, pos, box, ts, key):
        """(cost, entries) of kernel B1 over a list of tile size ``ts``
        sorted by ``key`` on this configuration: the modelled pair
        evaluations after its column skip plus PLIST_SLOT_COST a slot."""
        entries, evals = pair_plist.count_evaluations_np(
            pos, box, ts, self.system.r_cutoff + self.skin,
            self.system.r_cutoff, mode=key, inert=self._inert_mask)
        return evals + PLIST_SLOT_COST * entries * ts * ts, entries

    def refit_pair_list(self, pos_raw, box) -> str:
        """Re-size the pair list from the current configuration after a
        rebuild came back flagged: re-choose the sort key (a lattice start
        favours the z sort, whose tiles become slabs across the box once it
        has melted) and the nowrap axes (their frame budget no longer holds
        either), and grow the capacity if the candidates outgrew it.  The
        tile size stays: the padded per-atom tables are built for it.  The
        JAX package keeps all of these fixed from construction and runs the
        flagged list anyway (ROADMAP C).  Returns a note of what changed."""
        pos = np.asarray(self.place_vsites(pos_raw).detach().cpu(),
                         np.float64)
        box = np.asarray(box.detach().cpu(), np.float64)
        rc_cand = self.system.r_cutoff + self.skin
        old = (self.plist_sort, self.plist_nowrap, self.plist_cap)
        costs = {key: self._plist_cost(pos, box, self.pair_ts, key)
                 for key in ("z", "morton")}
        self.plist_sort = min(costs, key=lambda key: costs[key][0])
        cnt = costs[self.plist_sort][1]
        self.plist_nowrap = pair_plist.nowrap_axes_np(
            pos, box, self.pair_ts, rc_cand, mode=self.plist_sort)
        n_tiles = -(-self.system.n_atoms // self.pair_ts)
        if cnt > self.plist_cap:
            self.plist_cap = min(n_tiles * (n_tiles + 1) // 2,
                                 int(cnt * 1.6) + 64)
        return (f"sort {old[0]} -> {self.plist_sort}, nowrap {old[1]} -> "
                f"{self.plist_nowrap}, plist_cap {old[2]} -> "
                f"{self.plist_cap}")

    # -- gradient terms ----------------------------------------------------
    def _smooth_energy(self, pos, box):
        """The terms whose force comes from autograd: the Ewald reciprocal
        and the TT damping."""
        s, t = self.system, self.t
        terms = {}
        if s.ewald_beta > 0 and self.recip_method == "exact_fused":
            # kernels B4 (forward) and B5 (backward): nothing of size
            # (N, K) is stored
            terms["coul_recip"] = ewald_fused.reciprocal_energy_fused(
                pos, box, t.charges, s.ewald_beta, s.kmax, 256)
        elif s.ewald_beta > 0:
            terms["coul_recip"] = ewald.reciprocal_energy(
                pos, box, t.charges, s.ewald_beta, s.kmax,
                chunk=self.ewald_chunk)
        if s.tt_donors.shape[0] > 0:
            terms["tt_damping"] = nonbonded.tt_damping_energy(
                pos, box, t.tt_donors, t.tt_charges, t.tt_dipole_mask,
                t.exclusions, float(s.tt_b), float(s.tt_cutoff))
        return terms

    # -- full evaluation --------------------------------------------------
    @torch.no_grad()
    def energy_forces(self, pos_raw, box, want_energy: bool = True,
                      pair_cache=None, return_cov: bool = False):
        """Returns (terms dict, forces on real dofs), plus the pair
        coverage flag when ``return_cov``: a device bool, or a Python bool
        when ``strict_pairs`` has read it on the host already.  With
        ``want_energy=False`` the pair kernel takes its force-only
        specialization and the constraint-null springs are skipped."""
        s, t = self.system, self.t
        pos = self.place_vsites(pos_raw)
        cov = torch.zeros((), dtype=torch.bool, device=pos.device)
        if self.pair_mode == "plist":
            e_lj, e_coul_dir, e_corr, e14c, e14l, f_direct, cov = \
                pair_plist.direct_space_plist(
                    pos, box, t.charges, self.pair_tables, s.ewald_beta,
                    s.r_cutoff, self.pair_ts, want_energy=want_energy,
                    cache=pair_cache, plist_cap=self.plist_cap,
                    skin=self.skin, plist_sort=self.plist_sort,
                    r_switch=s.r_switch, strict=self.strict_pairs,
                    nowrap=self.plist_nowrap, statics=self.statics)
        elif self.pair_mode == "band":
            e_lj, e_coul_dir, e_corr, e14c, e14l, f_direct, cov = \
                pair_tri.direct_space_band(
                    pos, box, t.charges, self.pair_tables, s.ewald_beta,
                    s.r_cutoff, self.pair_ts, self.band_w,
                    want_energy=want_energy, cache=pair_cache,
                    r_switch=s.r_switch, strict=self.strict_pairs,
                    statics=self.statics)
        else:
            e_lj, e_coul_dir, e_corr, e14c, e14l, f_direct = \
                allpairs.direct_space_dense(
                    pos, box, t.charges, self.pair_tables, s.ewald_beta,
                    s.r_cutoff, row_block=self.row_block,
                    r_switch=s.r_switch)

        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            terms = self._smooth_energy(p, box)
            if terms:
                e_smooth = sum(terms.values())
                (grad_smooth,) = torch.autograd.grad(e_smooth, p)
            else:
                grad_smooth = torch.zeros_like(pos)
        terms = {k: v.detach() for k, v in terms.items()}
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
