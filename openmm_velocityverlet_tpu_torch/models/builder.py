"""SystemBuilder — programmatic construction of a System (counterpart of
``openmm_velocityverlet_tpu/models/builder.py``; host numpy, table for
table the same output).

Plays the role of OpenMM's ``System`` assembly inside
``OplsPsfFile.createSystem`` (oplspsffile.py:792+): collect particles, bonded
terms, exclusions/exceptions, Drude particles, Thole pairs, virtual sites and
constraints, then ``finalize()`` computes every derived table the engine
needs (per-atom exclusion/exception tables, LJ dispersion coefficients,
Drude spring constants, molecule connected components, Ewald parameters).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .. import trace
from ..ops.cmap import pack_cmap_maps
from ..ops.ewald import ewald_parameters
from ..system import System
from ..units import ONE_4PI_EPS0


class _UnionFind:
    def __init__(self, n):
        self.parent = list(range(n))

    def find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class SystemBuilder:
    def __init__(self):
        self.masses: list = []
        self.charges: list = []
        self.lj_type: list = []
        self.acoef: Optional[np.ndarray] = None
        self.bcoef: Optional[np.ndarray] = None
        self.bonds: list = []          # (i,j,r0,k)  E=0.5k(r-r0)^2
        self.angles: list = []         # (i,j,k,theta0,kth)
        self.ub_bonds: list = []
        self.dihedrals: list = []      # (i,j,k,l,n,phase,kphi)
        self.impropers: list = []      # (a2,a3,a1,a4,k) already reordered
        self.exclusions: set = set()   # frozenset pairs
        self.exceptions: dict = {}     # (i,j) -> (qq, sigma, eps)
        self.constraints: list = []    # (i,j,d)
        self.vsites: list = []         # (site,(p1,p2,p3),ow,xw,yw,local)
        self.drude: list = []          # (drude,parent,p2,p3,p4,charge,alpha,a12,a34)
        self.thole: list = []          # (d1,p1,d2,p2,qq,screen)
        self.nbt_idx: 'Optional[np.ndarray]' = None
        self.nbt_alpha: 'Optional[np.ndarray]' = None
        self.nbt_coef: 'Optional[np.ndarray]' = None
        self.tt_donors: list = []
        self.tt_charges: Optional[np.ndarray] = None
        self.tt_b = 45.0
        self.tt_cutoff = 1.2
        self.r_cutoff = 1.2
        self.ewald_tolerance = 5e-4
        self.use_pme = True
        self.use_dispersion_correction = True
        self.r_switch = 0.0
        self.remove_cm_motion = True
        self.extra_molecule_links: list = []  # e.g. run-edl fake bonds
        self.cmap_terms: list = []     # (8-tuple atoms, map index)
        self.cmap_grids: list = []     # (R,R) energy grids, kJ/mol
        self.lj_group: 'Optional[np.ndarray]' = None       # (N,) int
        self.lj_group_allowed: 'Optional[np.ndarray]' = None  # (G,G) bool

    # ------------------------------------------------------------ atoms
    def add_particle(self, mass, charge=0.0, lj_type=0):
        self.masses.append(float(mass))
        self.charges.append(float(charge))
        self.lj_type.append(int(lj_type))
        return len(self.masses) - 1

    def set_lj_tables(self, acoef, bcoef):
        self.acoef = np.asarray(acoef, np.float64)
        self.bcoef = np.asarray(bcoef, np.float64)

    def set_lj_from_type_params(self, sigmas, epsilons, nbfix=None):
        """Geometric (OPLS) combination rule with optional NBFIX overrides.
        a = sqrt(eps_ij) * rmin_ij^6 ... using E=(a/r6)^2 - b/r6 with
        rmin_ij = sqrt(rmin_i*rmin_j)... Here parameterized directly with
        (sigma, eps): a_ij = sqrt(sqrt(ei ej)) * ... matching
        oplspsffile.py:1296-1310 where rij = sqrt(rmin_i rmin_j)*2 and
        acoef = sqrt(wdij) rij^6, bcoef = 2 wdij rij^6 (rij is the pair
        minimum location = 2^(1/6) sigma_ij)."""
        sig = np.asarray(sigmas, np.float64)
        eps = np.asarray(epsilons, np.float64)
        t = len(sig)
        a = np.zeros((t, t))
        b = np.zeros((t, t))
        for i in range(t):
            for j in range(t):
                if nbfix and (i, j) in nbfix:
                    rij, wij = nbfix[(i, j)]
                else:
                    rij = math.sqrt(sig[i] * sig[j]) * 2.0 ** (1.0 / 6.0)
                    wij = math.sqrt(eps[i] * eps[j])
                a[i, j] = math.sqrt(wij) * rij ** 6
                b[i, j] = 2.0 * wij * rij ** 6
        self.set_lj_tables(a, b)

    # ---------------------------------------------------------- bonded
    def add_bond(self, i, j, r0, k):
        self.bonds.append((i, j, r0, k))

    def add_angle(self, i, j, k, theta0, kth):
        self.angles.append((i, j, k, theta0, kth))

    def add_urey_bradley(self, i, j, r0, k):
        self.ub_bonds.append((i, j, r0, k))

    def add_dihedral(self, i, j, k, l, n, phase, kphi):
        self.dihedrals.append((i, j, k, l, n, phase, kphi))

    def add_improper(self, a2, a3, a1, a4, k):
        self.impropers.append((a2, a3, a1, a4, k))

    def add_cmap_map(self, grid_kj):
        """Register a (R,R) CMAP energy grid (kJ/mol, phi/psi from -pi,
        CHARMM layout); returns the map index for add_cmap_term."""
        self.cmap_grids.append(np.asarray(grid_kj, np.float64))
        return len(self.cmap_grids) - 1

    def add_cmap_term(self, atoms8, map_index):
        """One cross-term: atoms8[:4] = phi dihedral, atoms8[4:] = psi
        (oplspsffile.py:1156-1168 — consecutive 5-atom terms pass
        (a1,a2,a3,a4, a2,a3,a4,a5))."""
        a = tuple(int(x) for x in atoms8)
        if len(a) != 8:
            raise ValueError("CMAP term needs 8 atom indices")
        self.cmap_terms.append((a, int(map_index)))

    # -------------------------------------------------------- nonbonded
    def add_exclusion(self, i, j):
        self.exclusions.add((min(i, j), max(i, j)))

    def add_exception(self, i, j, qq, sigma, eps):
        """qq in e^2 (already scaled); sigma nm; eps kJ/mol."""
        self.exceptions[(min(i, j), max(i, j))] = (qq, sigma, eps)
        self.add_exclusion(i, j)

    # ------------------------------------------------- constraints etc.
    def add_constraint(self, i, j, d):
        self.constraints.append((i, j, d))

    def add_vsite(self, site, parents, origin_w, x_w, y_w, local):
        self.vsites.append((site, tuple(parents), tuple(origin_w),
                            tuple(x_w), tuple(y_w), tuple(local)))

    def add_drude(self, drude, parent, p2, p3, p4, charge, alpha,
                  aniso12, aniso34):
        """OpenMM DrudeForce::addParticle semantics
        (oplspsffile.py:1480-1505): alpha in nm^3, charge in e."""
        self.drude.append((drude, parent, p2, p3, p4, charge, alpha,
                           aniso12, aniso34))

    def add_thole_pair(self, d1, p1, d2, p2, q1, q2, thole_sum, alpha1, alpha2):
        screen = thole_sum / (alpha1 * alpha2) ** (1.0 / 6.0)
        self.thole.append((d1, p1, d2, p2, q1 * q2, screen))

    def set_nbthole(self, nbt_idx, nbt_alpha, nbt_coef):
        """NBTHOLE screened-dipole tables (reference oplspsffile.py:1350-1405):
        per-atom type index (0 = none), alpha^(-1/6) in Angstrom units and
        the (T+1,T+1) coefficient matrix."""
        self.nbt_idx = np.asarray(nbt_idx, np.int32)
        self.nbt_alpha = np.asarray(nbt_alpha, np.float64)
        self.nbt_coef = np.asarray(nbt_coef, np.float64)

    def set_tt_damping(self, donors, charges, b=45.0, cutoff=1.2):
        self.tt_donors = list(donors)
        self.tt_charges = np.asarray(charges, np.float64)
        self.tt_b = float(b)
        self.tt_cutoff = float(cutoff)

    # --------------------------------------------------------- finalize
    def finalize(self, box, r_cutoff=None, use_pme=None,
                 ewald_tolerance=None) -> System:
        with trace.span("setup.finalize"):
            return self._finalize(box, r_cutoff, use_pme, ewald_tolerance)

    def _finalize(self, box, r_cutoff, use_pme, ewald_tolerance) -> System:
        n = len(self.masses)
        if r_cutoff is not None:
            self.r_cutoff = float(r_cutoff)
        if use_pme is not None:
            self.use_pme = bool(use_pme)
        if ewald_tolerance is not None:
            self.ewald_tolerance = float(ewald_tolerance)
        masses = np.asarray(self.masses, np.float32)
        inv_masses = np.where(masses > 0, 1.0 / np.maximum(masses, 1e-30), 0.0)
        charges = np.asarray(self.charges, np.float32)
        lj_type = np.asarray(self.lj_type, np.int32)
        if self.acoef is None:
            t = int(lj_type.max()) + 1 if n else 1
            self.acoef = np.zeros((t, t))
            self.bcoef = np.zeros((t, t))

        # molecules: connected components over bonds/constraints/drude/vsites
        uf = _UnionFind(n)
        for i, j, *_ in self.bonds:
            uf.union(i, j)
        for i, j, _ in self.constraints:
            uf.union(i, j)
        for d in self.drude:
            uf.union(d[0], d[1])
        for site, parents, *_ in self.vsites:
            for p in parents:
                uf.union(site, p)
        for i, j in self.extra_molecule_links:
            uf.union(i, j)
        roots = {}
        mol_id = np.zeros(n, np.int32)
        for i in range(n):
            r = uf.find(i)
            if r not in roots:
                roots[r] = len(roots)
            mol_id[i] = roots[r]
        n_mol = len(roots)
        mol_mass = np.zeros(n_mol, np.float64)
        np.add.at(mol_mass, mol_id, masses)
        mol_inv_mass = np.where(mol_mass > 0, 1.0 / np.maximum(mol_mass, 1e-30), 0.0)

        # per-atom exclusion table
        per_atom_excl = [[] for _ in range(n)]
        for i, j in self.exclusions:
            per_atom_excl[i].append(j)
            per_atom_excl[j].append(i)
        e_max = max((len(x) for x in per_atom_excl), default=0)
        excl = np.full((n, max(e_max, 1)), -1, np.int32)
        for i, lst in enumerate(per_atom_excl):
            excl[i, :len(lst)] = sorted(lst)

        # per-atom exception tables
        per_atom_exc = [[] for _ in range(n)]
        for (i, j), (qq, sigma, eps) in self.exceptions.items():
            c6 = 4.0 * eps * sigma ** 6
            c12 = 4.0 * eps * sigma ** 12
            per_atom_exc[i].append((j, qq, c6, c12))
            per_atom_exc[j].append((i, qq, c6, c12))
        x_max = max((len(x) for x in per_atom_exc), default=0)
        x_max = max(x_max, 1)
        exc_idx = np.full((n, x_max), -1, np.int32)
        exc_qq = np.zeros((n, x_max), np.float32)
        exc_c6 = np.zeros((n, x_max), np.float32)
        exc_c12 = np.zeros((n, x_max), np.float32)
        for i, lst in enumerate(per_atom_exc):
            for k, (j, qq, c6, c12) in enumerate(lst):
                exc_idx[i, k] = j
                exc_qq[i, k] = ONE_4PI_EPS0 * qq
                exc_c6[i, k] = c6
                exc_c12[i, k] = c12

        # dispersion-correction coefficients (type-count weighted)
        t = self.acoef.shape[0]
        counts = np.bincount(lj_type, minlength=t).astype(np.float64)
        disp_a2 = float(np.einsum("i,j,ij->", counts, counts, self.acoef ** 2))
        disp_b = float(np.einsum("i,j,ij->", counts, counts, self.bcoef))

        # Drude spring constants (OpenMM Drude kernel initialization):
        # a3 = 3-a1-a2; k3 = C q^2/(alpha a3); k1 = C q^2/(alpha a1)-k3; ...
        dr_pairs, dr_k1, dr_k2, dr_k3, dr_aniso = [], [], [], [], []
        for (d, p, p2, p3, p4, q, alpha, a12, a34) in self.drude:
            has_aniso = p2 >= 0 and p3 >= 0 and p4 >= 0
            a1 = a12 if has_aniso else 1.0
            a2 = a34 if has_aniso else 1.0
            a3 = 3.0 - a1 - a2
            kk = ONE_4PI_EPS0 * q * q / alpha
            k3 = kk / a3
            k1 = kk / a1 - k3 if has_aniso else 0.0
            k2 = kk / a2 - k3 if has_aniso else 0.0
            dr_pairs.append((d, p))
            dr_k1.append(k1)
            dr_k2.append(k2)
            dr_k3.append(k3)
            dr_aniso.append((p, p2, p3, p4) if has_aniso else (-1, -1, -1, -1))

        # System arrays stay host-side numpy; System.to(device) uploads
        def iarr(x, w=None):
            a = np.asarray(x, np.int32)
            if w is not None:
                a = a.reshape(-1, w)
            return a

        def farr(x):
            return np.asarray(x, np.float32)

        bonds = np.asarray([(b[0], b[1]) for b in self.bonds], np.int32).reshape(-1, 2)
        angles = np.asarray([(a[0], a[1], a[2]) for a in self.angles],
                            np.int32).reshape(-1, 3)
        ubs = np.asarray([(u[0], u[1]) for u in self.ub_bonds],
                         np.int32).reshape(-1, 2)
        dihs = np.asarray([(d[0], d[1], d[2], d[3]) for d in self.dihedrals],
                          np.int32).reshape(-1, 4)
        imps = np.asarray([(p[0], p[1], p[2], p[3]) for p in self.impropers],
                          np.int32).reshape(-1, 4)
        consx = np.asarray([(c[0], c[1]) for c in self.constraints],
                           np.int32).reshape(-1, 2)

        # dense molecule-member table for scatter-free COM reductions;
        # massless members (virtual sites, image particles) carry no
        # momentum/mass and only widen the gather, so they are excluded
        # (every consumer is mass-weighted)
        n_mol_total = int(mol_id.max()) + 1 if n else 0
        massive = masses > 0
        counts = np.bincount(mol_id[massive], minlength=n_mol_total)
        mmax = int(counts.max()) if n_mol_total and counts.size else 1
        mol_table = np.full((n_mol_total, max(mmax, 1)), -1, np.int32)
        fill = np.zeros(n_mol_total, np.int32)
        for i, m in enumerate(mol_id):
            if masses[i] > 0:
                mol_table[m, fill[m]] = i
                fill[m] += 1

        box = np.asarray(box, np.float64)
        if self.use_pme:
            beta, kmax = ewald_parameters(self.r_cutoff,
                                          self.ewald_tolerance, box)
        else:
            beta, kmax = 0.0, (0, 0, 0)

        if self.tt_charges is None:
            tt_charges = np.zeros(n, np.float32)
        else:
            tt_charges = np.asarray(self.tt_charges, np.float32)
        tt_dipole_mask = np.zeros(n, bool)
        for d in self.drude:
            tt_dipole_mask[d[0]] = True
            tt_dipole_mask[d[1]] = True

        cmap_coeffs, cmap_res = pack_cmap_maps(self.cmap_grids)

        return System(
            masses=farr(masses), inv_masses=farr(inv_masses),
            charges=farr(charges), lj_type=np.asarray(lj_type, np.int32),
            acoef=farr(self.acoef), bcoef=farr(self.bcoef),
            lj_group=(np.asarray(self.lj_group, np.int32)
                      if self.lj_group is not None
                      else np.zeros(n, np.int32)),
            lj_group_allowed=(np.asarray(self.lj_group_allowed, bool)
                              if self.lj_group_allowed is not None
                              else np.ones((1, 1), bool)),
            bonds=iarr(bonds), bond_r0=farr([b[2] for b in self.bonds]),
            bond_k=farr([b[3] for b in self.bonds]),
            angles=iarr(angles), angle_theta0=farr([a[3] for a in self.angles]),
            angle_k=farr([a[4] for a in self.angles]),
            ub_bonds=iarr(ubs), ub_r0=farr([u[2] for u in self.ub_bonds]),
            ub_k=farr([u[3] for u in self.ub_bonds]),
            dihedrals=iarr(dihs),
            dihedral_n=farr([d[4] for d in self.dihedrals]),
            dihedral_phase=farr([d[5] for d in self.dihedrals]),
            dihedral_k=farr([d[6] for d in self.dihedrals]),
            impropers=iarr(imps), improper_k=farr([p[4] for p in self.impropers]),
            cmap_atoms=(np.asarray([t[0] for t in self.cmap_terms], np.int32)
                        if self.cmap_terms else np.zeros((0, 8), np.int32)),
            cmap_map=np.asarray([t[1] for t in self.cmap_terms], np.int32),
            cmap_coeffs=cmap_coeffs, cmap_res=cmap_res,
            exclusions=np.asarray(excl, np.int32),
            exc_idx=np.asarray(exc_idx, np.int32), exc_qq=np.asarray(exc_qq, np.float32),
            exc_c6=np.asarray(exc_c6, np.float32), exc_c12=np.asarray(exc_c12, np.float32),
            disp_coef_a2=np.float32(disp_a2),
            disp_coef_b=np.float32(disp_b),
            constraints=iarr(consx),
            constraint_dist=farr([c[2] for c in self.constraints]),
            vsite_index=iarr([v[0] for v in self.vsites]),
            vsite_parents=iarr([v[1] for v in self.vsites], 3) if self.vsites
            else np.zeros((0, 3), np.int32),
            vsite_origin_w=farr([v[2] for v in self.vsites]).reshape(-1, 3),
            vsite_x_w=farr([v[3] for v in self.vsites]).reshape(-1, 3),
            vsite_y_w=farr([v[4] for v in self.vsites]).reshape(-1, 3),
            vsite_local=farr([v[5] for v in self.vsites]).reshape(-1, 3),
            drude_pairs=iarr(dr_pairs, 2) if dr_pairs else np.zeros((0, 2), np.int32),
            drude_k3=farr(dr_k3), drude_k1=farr(dr_k1), drude_k2=farr(dr_k2),
            drude_aniso=iarr(dr_aniso, 4) if dr_aniso else np.zeros((0, 4), np.int32),
            thole_sites=iarr([(t[0], t[1], t[2], t[3]) for t in self.thole], 4)
            if self.thole else np.zeros((0, 4), np.int32),
            thole_qq=farr([t[4] for t in self.thole]),
            thole_screen=farr([t[5] for t in self.thole]),
            nbt_idx=(np.asarray(self.nbt_idx, np.int32)
                     if self.nbt_idx is not None else np.zeros(n, np.int32)),
            nbt_alpha=(farr(self.nbt_alpha) if self.nbt_alpha is not None
                       else np.zeros(n, np.float32)),
            nbt_coef=(farr(self.nbt_coef) if self.nbt_coef is not None
                      else np.zeros((1, 1), np.float32)),
            tt_donors=iarr(self.tt_donors),
            tt_charges=farr(tt_charges),
            tt_dipole_mask=np.asarray(tt_dipole_mask),
            tt_b=np.float32(self.tt_b),
            tt_cutoff=np.float32(self.tt_cutoff),
            particle_mol_id=np.asarray(mol_id, np.int32),
            mol_masses=farr(mol_mass), mol_inv_masses=farr(mol_inv_mass),
            mol_table=mol_table,
            r_cutoff=self.r_cutoff, r_switch=float(self.r_switch),
            ewald_beta=float(beta), kmax=tuple(kmax),
            use_dispersion_correction=self.use_dispersion_correction,
            has_cm_motion_remover=self.remove_cm_motion,
        )
