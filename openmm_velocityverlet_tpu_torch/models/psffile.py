"""OplsPsfFile — CHARMM/Drude PSF parser + OPLS/CLPol polarizable force-field
system builder (counterpart of ``openmm_velocityverlet_tpu/models/
psffile.py``, host Python on the port's ``SystemBuilder``; the same tables).

Re-implements the behavior of the reference's bundled system builder
(examples/ommhelper/oplspsffile.py):

* PSF parsing incl. the Drude columns (alpha, thole), Drude-pair detection by
  atom-name prefix 'D', lone-pair ('LP'/'OM') bond filtering
  (oplspsffile.py:262-281), NUMLP/NUMLPH lone-pair sections (:384-411) and
  NUMANISO anisotropy sections (:413-429).
* Parameter assignment with the same key/wildcard rules (:628-692).
* create_system: HBond/rigid-water constraints, lone-pair LocalCoordinates
  virtual sites, bonded forces with CHARMM 2x conventions, OPLS geometric-rule
  tabulated LJ with NBFIX, PME charges with 1-4 exceptions scaled by 1/2,
  Drude/lone-pair exclusion expansion, DrudeForce with anisotropy solving and
  1-2/1-3 Thole screened pairs (:900-1528).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..units import ANGSTROM_TO_NM, DEGREE_TO_RAD, KCAL_TO_KJ
from .builder import SystemBuilder
from .prmfile import CharmmParameterSet

WATNAMES = ("WAT", "HOH", "TIP3", "TIP4", "TIP5", "SPC", "SPCE", "SWM4")

# CHARMM -> MD unit conversion factors
_BOND_K = KCAL_TO_KJ / ANGSTROM_TO_NM ** 2   # kcal/mol/A^2 -> kJ/mol/nm^2
_ANGLE_K = KCAL_TO_KJ                        # kcal/mol/rad^2 -> kJ/mol/rad^2
_ENE = KCAL_TO_KJ
_LEN = ANGSTROM_TO_NM


@dataclass
class Topology:
    """Light topology: what reporters, GRO output and the workload scripts'
    group selections need."""
    atom_names: List[str] = field(default_factory=list)
    atom_types: List[str] = field(default_factory=list)
    residue_ids: List[int] = field(default_factory=list)
    residue_names: List[str] = field(default_factory=list)
    segment_ids: List[str] = field(default_factory=list)

    @property
    def n_atoms(self):
        return len(self.atom_names)

    def select_by_residue_name(self, *names, invert=False):
        if invert:
            return [i for i, r in enumerate(self.residue_names)
                    if r not in names]
        return [i for i, r in enumerate(self.residue_names) if r in names]


def _element_is_h(mass):
    return 0.0 < mass < 3.5


def _element_is_o(mass):
    return 14.0 < mass < 18.0


class OplsPsfFile:
    def __init__(self, psf_name: str, periodicBoxVectors=None):
        self.box = (None if periodicBoxVectors is None
                    else np.diag(np.asarray(periodicBoxVectors)))
        sections = self._parse_sections(psf_name)
        self.is_drude = self._is_drude

        natom = int(sections["NATOM"][0][0])
        top = Topology()
        charges = np.zeros(natom)
        masses = np.zeros(natom)
        self.drudeconsts = np.zeros((natom, 2))  # (alpha A^3 neg, thole)
        for i in range(natom):
            w = sections["NATOM"][1][i].split()
            top.segment_ids.append(w[1])
            top.residue_ids.append(int("".join(c for c in w[2]
                                               if c.isdigit())))
            top.residue_names.append(w[3])
            top.atom_names.append(w[4])
            top.atom_types.append(w[5])
            charges[i] = float(w[6])
            masses[i] = float(w[7])
            if self.is_drude:
                self.drudeconsts[i] = (float(w[9]), float(w[10]))
        self.topology = top
        self.charges = charges
        self.masses = masses
        self.atom_list = [_AtomView(self, i) for i in range(natom)]

        # bonds: filter Drude pairs (name starts 'D') and lone pairs
        # ('LP*'/'OM') exactly like oplspsffile.py:268-281
        raw = sections["NBOND"][1]
        ids = [int(x) for line in raw for x in line.split()]
        self.bonds = []
        self.drude_pair_list = []     # (parent, drude) with parent = min
        for k in range(len(ids) // 2):
            i, j = ids[2 * k] - 1, ids[2 * k + 1] - 1
            ni, nj = top.atom_names[i], top.atom_names[j]
            if ni[0] == "D" or nj[0] == "D":
                self.drude_pair_list.append((min(i, j), max(i, j)))
            elif ni[:2] == "LP" or nj[:2] == "LP" or ni == "OM" or nj == "OM":
                pass
            else:
                self.bonds.append((i, j))

        def quads(name, k):
            raw = sections[name][1]
            ids = [int(x) for line in raw for x in line.split()]
            return [tuple(ids[k * m + t] - 1 for t in range(k))
                    for m in range(len(ids) // k)]

        self.angles = quads("NTHETA", 3)
        self.dihedrals = quads("NPHI", 4)
        self.impropers = quads("NIMPHI", 4)

        # CMAP cross-terms (oplspsffile.py:430-451): 8 atom indices per
        # term = two dihedrals (phi = [:4], psi = [4:])
        self.cmaps = []
        if "NCRTERM" in sections and sections["NCRTERM"][0] \
                and int(sections["NCRTERM"][0][0]) > 0:
            ncrterm = int(sections["NCRTERM"][0][0])
            flat = [int(x) for line in sections["NCRTERM"][1]
                    for x in line.split()]
            if len(flat) != ncrterm * 8:
                raise ValueError(
                    f"Got {len(flat)} CMAP indexes for {ncrterm} terms")
            self.cmaps = [tuple(flat[8 * m + t] - 1 for t in range(8))
                          for m in range(ncrterm)]

        # lone pairs (NUMLP NUMLPH), oplspsffile.py:384-411
        self.lonepairs = []
        if "NUMLP NUMLPH" in sections:
            ptr, holder = sections["NUMLP NUMLPH"]
            numlp = int(ptr[0])
            if numlp:
                heads = []
                for i in range(numlp):
                    w = holder[i].split()
                    if len(w) != 6 or w[2] != "F":
                        raise ValueError("Lonepair format error")
                    heads.append((int(w[0]), float(w[3]), float(w[4]),
                                  float(w[5])))
                flat = [int(x) for line in holder[numlp:] for x in line.split()]
                c = 0
                for (nhost, dist, ang, dih) in heads:
                    idall = [flat[c + j] - 1 for j in range(nhost + 1)]
                    c += nhost + 1
                    if len(idall) == 3:
                        idall.append(-1)  # colinear marker
                    self.lonepairs.append(idall[:4] + [dist, ang, dih])

        # anisotropy (NUMANISO), oplspsffile.py:413-429
        self.aniso_list = []
        if self.is_drude and "NUMANISO" in sections:
            ptr, holder = sections["NUMANISO"]
            numaniso = int(ptr[0])
            if numaniso:
                ks = [tuple(float(x) for x in holder[i].split()[:3])
                      for i in range(numaniso)]
                flat = [int(x) for line in holder[numaniso:]
                        for x in line.split()]
                for i in range(numaniso):
                    id1, id2, id3, id4 = (flat[4 * i + t] - 1 for t in range(4))
                    self.aniso_list.append([id1, id2, id3, id4, *ks[i]])

    # ------------------------------------------------------------ parsing
    def _parse_sections(self, psf_name):
        with open(psf_name) as f:
            first = f.readline()
            if not first.startswith("PSF"):
                raise ValueError("not a PSF file")
            self._is_drude = "DRUDE" in first.split()[1:]
            sections = {}
            title = None
            lines = f.read().splitlines()
        i = 0
        cur = None
        while i < len(lines):
            line = lines[i]
            if "!" in line:
                head, _, tag = line.partition("!")
                tag = tag.split(":")[0].strip()
                ptr = head.split()
                sections[tag] = (ptr, [])
                cur = tag
            elif cur is not None and line.strip():
                sections[cur][1].append(line)
            i += 1
        return sections

    # -------------------------------------------------------- the builder
    def createSystem(self, params: CharmmParameterSet, nonbondedCutoff=1.2,
                     constraints="HBonds", rigidWater=True, verbose=False,
                     ewaldErrorTolerance=5e-4, use_pme=True,
                     implicitSolvent=None, implicitSolventKappa=None,
                     implicitSolventSaltConc=0.0, temperature=298.15,
                     soluteDielectric=1.0, solventDielectric=78.5,
                     gbsaModel=None, removeCMMotion=True,
                     hydrogenMass=None, flexibleConstraints=True,
                     switchDistance=0.0,
                     nonbondedMethod=None) -> "BuiltSystem":
        """implicitSolvent: None | 'HCT' | 'OBC1' | 'OBC2' (GB models,
        reference oplspsffile.py:797-799, 1532-1590; 'GBn'/'GBn2' raise —
        their neck-integral tables are not implemented).  The remaining GB
        kwargs mirror the reference's semantics: kappa from salt
        concentration (oplspsffile.py:1536-1550), ACE SASA via
        gbsaModel='ACE', dielectrics as given.  removeCMMotion and
        hydrogenMass mirror oplspsffile.py:1593-1610."""
        # nonbondedMethod (reference createSystem, oplspsffile.py:792):
        # OpenMM's enum mapped onto this engine's reciprocal-space choice.
        # PME/Ewald -> Ewald electrostatics (Context's recip= picks FFT PME
        # or exact-k); NoCutoff/CutoffPeriodic/CutoffNonPeriodic -> plain
        # cutoff Coulomb (beta = 0).  use_pme= remains the low-level knob.
        if nonbondedMethod is not None:
            methods = {"PME": True, "Ewald": True, "LJPME": None,
                       "NoCutoff": False, "CutoffPeriodic": False,
                       "CutoffNonPeriodic": False}
            if nonbondedMethod not in methods:
                raise ValueError(
                    f"nonbondedMethod must be one of {sorted(methods)}, "
                    f"got {nonbondedMethod!r}")
            if methods[nonbondedMethod] is None:
                raise NotImplementedError(
                    "LJPME is not implemented (no reference workload "
                    "uses it)")
            use_pme = methods[nonbondedMethod]
        top = self.topology
        n = top.n_atoms
        b = SystemBuilder()
        b.ewald_tolerance = ewaldErrorTolerance
        # LJ switching function (oplspsffile.py:1335-1345, with the
        # reference's validation errors)
        if switchDistance:
            if switchDistance >= nonbondedCutoff:
                raise ValueError(
                    "switchDistance is too large compared to the cutoff!")
            if switchDistance < 0:
                raise ValueError("switchDistance must be non-negative!")
            b.r_switch = float(switchDistance)

        for i in range(n):
            b.add_particle(self.masses[i], charge=self.charges[i])

        # ---- constraints (oplspsffile.py:939-960) ----
        def is_water_bond(i, j):
            return (top.residue_names[i][:4].upper() in WATNAMES and
                    tuple(sorted((_element_is_h(self.masses[i]),
                                  _element_is_h(self.masses[j])))) == (False, True))

        constrained_bonds = set()
        for (i, j) in self.bonds:
            key = params.bond(top.atom_types[i], top.atom_types[j])
            req_nm = key[1] * _LEN
            hbond = _element_is_h(self.masses[i]) or _element_is_h(self.masses[j])
            if (constraints == "HBonds" and hbond) or \
               (rigidWater and constraints is None and is_water_bond(i, j)):
                b.add_constraint(i, j, req_nm)
                constrained_bonds.add((min(i, j), max(i, j)))

        # ---- lone-pair virtual sites (oplspsffile.py:964-992) ----
        bond_set = set((min(i, j), max(i, j)) for i, j in self.bonds)
        for lp in self.lonepairs:
            index, atom1, atom2, atom3, dist, ang, dih = lp
            if atom3 >= 0:
                if dist > 0:     # relative
                    r = dist * _LEN
                    xw = [-1.0, 0.0, 1.0]
                else:            # bisector
                    r = -dist * _LEN
                    xw = [-1.0, 0.5, 0.5]
                theta = ang * DEGREE_TO_RAD
                phi = (180.0 - dih) * DEGREE_TO_RAD
                p = [r * math.cos(theta),
                     r * math.sin(theta) * math.cos(phi),
                     r * math.sin(theta) * math.sin(phi)]
                p = [x if abs(x) > 1e-10 else 0.0 for x in p]
                b.add_vsite(index, (atom1, atom3, atom2), (1.0, 0.0, 0.0),
                            xw, (0.0, -1.0, 1.0), p)
            else:                # colinear: find third real atom
                a3 = None
                for (x, y) in self.bonds:
                    if x == atom2 and y != atom1:
                        a3 = y
                    elif y == atom2 and x != atom1:
                        a3 = x
                r = dist * _LEN
                b.add_vsite(index, (atom1, atom2, a3), (1.0, 0.0, 0.0),
                            (1.0, -1.0, 0.0), (0.0, -1.0, 1.0), (r, 0.0, 0.0))

        # ---- bonded terms ----
        # flexibleConstraints=True (the reference default) KEEPS the spring
        # terms of constrained DOF (oplspsffile.py:1000-1008): with the
        # constraint exactly satisfied they contribute ~zero energy and
        # their along-bond forces are projected away by RATTLE, but the
        # reported bond energy at arbitrary configurations matches OpenMM.
        for (i, j) in self.bonds:
            if not flexibleConstraints:
                if constraints is not None and (
                        _element_is_h(self.masses[i])
                        or _element_is_h(self.masses[j])):
                    continue
                if (rigidWater and is_water_bond(i, j)):
                    continue
            k, req = params.bond(top.atom_types[i], top.atom_types[j])
            b.add_bond(i, j, req * _LEN, 2.0 * k * _BOND_K)

        for (i, j, k3) in self.angles:
            (ka, th0), ub = params.angle(top.atom_types[i], top.atom_types[j],
                                         top.atom_types[k3])
            hh = _element_is_h(self.masses[i]) and _element_is_h(self.masses[k3])
            if (rigidWater and hh and _element_is_o(self.masses[j])
                    and top.residue_names[i][:4].upper() in WATNAMES):
                # constrain the H-H distance instead (rigid water)
                l1 = params.bond(top.atom_types[i], top.atom_types[j])[1] * _LEN
                l2 = params.bond(top.atom_types[k3], top.atom_types[j])[1] * _LEN
                d = math.sqrt(l1 * l1 + l2 * l2
                              - 2 * l1 * l2 * math.cos(th0 * DEGREE_TO_RAD))
                b.add_constraint(i, k3, d)
                if flexibleConstraints:     # oplspsffile.py:1055-1058
                    b.add_angle(i, j, k3, th0 * DEGREE_TO_RAD,
                                2.0 * ka * _ANGLE_K)
            else:
                b.add_angle(i, j, k3, th0 * DEGREE_TO_RAD, 2.0 * ka * _ANGLE_K)
            if ub is not None:
                b.add_urey_bradley(i, k3, ub[1] * _LEN, 2.0 * ub[0] * _BOND_K)

        for (i, j, k3, l) in self.dihedrals:
            for (kchi, per, delta) in params.dihedral(
                    top.atom_types[i], top.atom_types[j], top.atom_types[k3],
                    top.atom_types[l]):
                b.add_dihedral(i, j, k3, l, per, delta * DEGREE_TO_RAD,
                               kchi * _ENE)

        # OPLS improper: third atom central, E = k (1-cos 2 theta)
        # (oplspsffile.py:1125-1133 reorders to atom2, atom3, atom1, atom4)
        for (i, j, k3, l) in self.impropers:
            kpsi, _ = params.improper(top.atom_types[i], top.atom_types[j],
                                      top.atom_types[k3], top.atom_types[l])
            b.add_improper(j, k3, i, l, kpsi * _ENE)

        # CMAP cross-terms (oplspsffile.py:692-710 matching, :1134-1169
        # force construction): dedupe identical grids into shared maps
        cmap_map_idx = {}
        for atoms8 in self.cmaps:
            types8 = tuple(top.atom_types[a] for a in atoms8)
            res, grid = params.cmap(*types8)
            key = params._cmap_key(*(t.upper() for t in types8))
            if key not in cmap_map_idx:
                cmap_map_idx[key] = b.add_cmap_map(grid * _ENE)
            b.add_cmap_term(atoms8, cmap_map_idx[key])

        # ---- LJ types (one per distinct attype) ----
        typenames = sorted(set(top.atom_types))
        tindex = {t: i for i, t in enumerate(typenames)}
        for i in range(n):
            b.lj_type[i] = tindex[top.atom_types[i]]
        T = len(typenames)
        acoef = np.zeros((T, T))
        bcoef = np.zeros((T, T))
        for ti, tn1 in enumerate(typenames):
            at1 = params.atom_types[tn1]
            for tj, tn2 in enumerate(typenames):
                at2 = params.atom_types[tn2]
                if tn2 in at1.nbfix:
                    eps, rmin, _, _ = at1.nbfix[tn2]
                    rij = rmin * _LEN
                    wdij = eps * _ENE
                else:
                    rij = math.sqrt(at1.rmin_half * at2.rmin_half) * 2 * _LEN
                    wdij = math.sqrt(at1.epsilon * at2.epsilon) * _ENE
                acoef[ti, tj] = math.sqrt(wdij) * rij ** 6
                bcoef[ti, tj] = 2.0 * wdij * rij ** 6
        b.set_lj_tables(acoef, bcoef)

        # ---- NBTHOLE screened-dipole tables (oplspsffile.py:1350-1405) ----
        # Each parent atom whose type carries NBTHOLE entries gets an nbt
        # type index (starting at 1), shared with its Drude particle; alpha
        # factor = (-drudeconsts_alpha)^(-1/6) in Angstrom units (the engine
        # screen formula multiplies by 10 for the nm conversion).
        if any(params.atom_types[t].nbthole for t in typenames):
            drude_of = dict(self.drude_pair_list)
            nbt_idx = np.zeros(n, np.int32)
            nbt_alpha = np.zeros(n, np.float64)
            nbt_types = []                      # type names, index = id - 1
            for i in range(n):
                tname = top.atom_types[i]
                at = params.atom_types[tname]
                if not at.nbthole or nbt_idx[i]:
                    continue
                if tname in nbt_types:
                    tid = nbt_types.index(tname) + 1
                else:
                    nbt_types.append(tname)
                    tid = len(nbt_types)
                alpha = self.drudeconsts[i][0]
                if abs(alpha) < 1e-10:
                    continue                    # no Drude alpha: inert
                aval = (-alpha) ** (-1.0 / 6.0)
                members = [i] + ([drude_of[i]] if i in drude_of else [])
                for m in members:
                    nbt_idx[m] = tid
                    nbt_alpha[m] = aval
            tt = len(nbt_types) + 1
            coef = np.zeros((tt, tt))
            for a_i, tn1 in enumerate(nbt_types):
                for a_j, tn2 in enumerate(nbt_types):
                    coef[a_i + 1, a_j + 1] = \
                        params.atom_types[tn1].nbthole.get(tn2, 0.0)
            b.set_nbthole(nbt_idx, nbt_alpha, coef)

        # ---- exclusions / exceptions (oplspsffile.py:1408-1476) ----
        p12, p13, p14 = self._build_exclusion_lists()
        sigma_scale = 2.0 ** (-1.0 / 6.0)
        for (ia1, ia4) in p14:
            at1 = params.atom_types[top.atom_types[ia1]]
            at4 = params.atom_types[top.atom_types[ia4]]
            qq = self.charges[ia1] * self.charges[ia4] / 2.0
            eps = math.sqrt(at1.epsilon_14 * at4.epsilon_14) * _ENE
            sigma = math.sqrt(at1.rmin_14_half * 2 * at4.rmin_14_half * 2) * (
                _LEN * sigma_scale)
            b.add_exception(ia1, ia4, qq, sigma, eps)

        parent_attach = [[] for _ in range(n)]
        for lp in self.lonepairs:
            parent_attach[lp[1]].append(lp[0])
            b.add_exception(lp[1], lp[0], 0.0, 0.1, 0.0)
        if self.is_drude:
            for (parent, drude) in self.drude_pair_list:
                parent_attach[parent].append(drude)
                b.add_exception(parent, drude, 0.0, 0.1, 0.0)
            for attach in parent_attach:
                for i in range(len(attach)):
                    for j in range(i):
                        b.add_exception(attach[j], attach[i], 0.0, 0.1, 0.0)
        for (ia1, ia2) in p12 + p13:
            for e1 in [ia1] + parent_attach[ia1]:
                for e2 in [ia2] + parent_attach[ia2]:
                    b.add_exclusion(e1, e2)
        for (ia1, ia4) in p14:
            for e1 in [ia1] + parent_attach[ia1]:
                for e4 in [ia4] + parent_attach[ia4]:
                    if e1 == ia1 and e4 == ia4:
                        continue
                    qq = self.charges[e1] * self.charges[e4] / 2.0
                    b.add_exception(e1, e4, qq, 0.1, 0.0)

        # ---- Drude force + Thole pairs (oplspsffile.py:1478-1517) ----
        if self.is_drude:
            drude_of = {}
            for (parent, drude) in self.drude_pair_list:
                drude_of[parent] = drude
                p = [-1, -1, -1]
                a11 = a22 = 0.0
                for an in self.aniso_list:
                    if an[0] == parent:
                        p = [an[1], an[2], an[3]]
                        k11, k22, k33 = an[4], an[5], an[6]
                        aa = k11 + k22 + 3 * k33
                        bb = 2 * k11 * k22 + 4 * k11 * k33 + 4 * k22 * k33 \
                            + 6 * k33 * k33
                        cc = 3 * k33 * (k11 + k33) * (k22 + k33)
                        drude_k = (math.sqrt(bb * bb - 4 * aa * cc) - bb) / 2 / aa
                        a11 = round(drude_k / (k11 + k33 + drude_k), 5)
                        a22 = round(drude_k / (k22 + k33 + drude_k), 5)
                alpha = self.drudeconsts[parent][0] / (-1000.0)  # A^3 -> nm^3
                b.add_drude(drude, parent, p[0], p[1], p[2],
                            self.charges[drude], alpha, a11, a22)
            TINY = 1e-10
            for (ia1, ia2) in p12 + p13:
                alpha1 = self.drudeconsts[ia1][0]
                alpha2 = self.drudeconsts[ia2][0]
                if abs(alpha1) > TINY and abs(alpha2) > TINY:
                    thole = self.drudeconsts[ia1][1] + self.drudeconsts[ia2][1]
                    d1 = ia1 + 1  # CHARMM rule: Drude follows its parent
                    d2 = ia2 + 1
                    b.add_thole_pair(d1, ia1, d2, ia2, self.charges[d1],
                                     self.charges[d2], thole,
                                     -alpha1 / 1000.0, -alpha2 / 1000.0)

        # ---- hydrogen-mass repartitioning (oplspsffile.py:1593-1607) ----
        if hydrogenMass is not None:
            def _is_real_h(m):
                return 0.9 < m < 3.5        # excludes Drude (~0.4) and vsites
            for (i, j) in self.bonds:
                hi, hj = _is_real_h(b.masses[i]), _is_real_h(b.masses[j])
                if hi == hj:
                    continue
                h, heavy = (i, j) if hi else (j, i)
                transfer = float(hydrogenMass) - b.masses[h]
                b.masses[heavy] -= transfer
                b.masses[h] = float(hydrogenMass)

        b.remove_cm_motion = bool(removeCMMotion)

        # ---- implicit solvent (oplspsffile.py:1532-1590) ----
        gbdata = None
        if implicitSolvent is not None:
            from ..ops import gb as gb_mod
            if gbsaModel not in ("ACE", None):
                raise ValueError("gbsaModel must be ACE or None")
            if implicitSolvent in ("GBn", "GBn2"):
                raise NotImplementedError(
                    "GBn/GBn2 neck-integral tables are not implemented; "
                    "use HCT, OBC1 or OBC2")
            models = {"HCT": gb_mod.GB_HCT, "OBC1": gb_mod.GB_OBC1,
                      "OBC2": gb_mod.GB_OBC2}
            if implicitSolvent not in models:
                raise ValueError(
                    f"implicitSolvent must be one of "
                    f"{sorted(models)} or GBn/GBn2, got {implicitSolvent!r}")
            if use_pme:
                raise ValueError(
                    "Illegal nonbonded method for use with GBSA "
                    "(oplspsffile.py:1585-1586) — build with use_pme=False")
            if implicitSolventKappa is None:
                if implicitSolventSaltConc > 0:
                    # sander/pmemd conversion (oplspsffile.py:1541-1550):
                    # 1/sqrt(eps0 kB / (2 NA q^2 1e3)), x0.73 ion exclusion,
                    # x10 to 1/nm
                    implicitSolventKappa = 7.3 * 50.33355 * math.sqrt(
                        implicitSolventSaltConc / solventDielectric
                        / temperature)
                else:
                    implicitSolventKappa = 0.0
            gbdata = gb_mod.build_gb_data(
                b.masses, self.bonds, models[implicitSolvent],
                solute_dielectric=soluteDielectric,
                solvent_dielectric=solventDielectric,
                kappa=implicitSolventKappa, sasa=(gbsaModel == "ACE"))
            # NoCutoff semantics: no periodic LJ tail correction
            b.use_dispersion_correction = False

        box = (self.box if self.box is not None
               else np.array([3.0, 3.0, 3.0]))
        system = b.finalize(box, r_cutoff=nonbondedCutoff, use_pme=use_pme)
        if gbdata is not None:
            system = system.replace(gb=gbdata)
        return BuiltSystem(system=system, builder=b, topology=top, psf=self)

    def _build_exclusion_lists(self):
        """1-2/1-3/1-4 pair lists from the real-atom bond graph
        (oplspsffile.py:480-509)."""
        partners = {}
        for (i, j) in self.bonds:
            partners.setdefault(i, set()).add(j)
            partners.setdefault(j, set()).add(i)
        p12, p13, p14 = set(), set(), set()
        for (i, j) in self.bonds:
            p12.add((min(i, j), max(i, j)))
        for (a2, a3) in self.bonds:
            for a1 in partners.get(a2, ()):
                if a1 != a3:
                    p13.add((min(a1, a3), max(a1, a3)))
            for a4 in partners.get(a3, ()):
                if a4 != a2:
                    p13.add((min(a2, a4), max(a2, a4)))
        for (a2, a3) in self.bonds:
            for a1 in partners.get(a2, ()):
                for a4 in partners.get(a3, ()):
                    if a1 != a3 and a2 != a4 and a1 != a4:
                        p14.add((min(a1, a4), max(a1, a4)))
        p13 -= p12
        p14 -= p13 | p12
        return sorted(p12), sorted(p13), sorted(p14)


class _AtomView:
    """Minimal atom accessor so reference-style code like
    ``[a.idx for a in psf.atom_list if a.attype == 'HO']`` works."""

    __slots__ = ("_psf", "idx")

    def __init__(self, psf, idx):
        self._psf = psf
        self.idx = idx

    @property
    def attype(self):
        return self._psf.topology.atom_types[self.idx]

    @property
    def name(self):
        return self._psf.topology.atom_names[self.idx]

    @property
    def resname(self):
        return self._psf.topology.residue_names[self.idx]


@dataclass
class BuiltSystem:
    """createSystem output: the finalized System plus the builder (for
    post-build mutation a la run-edl.py) and the topology."""
    system: object
    builder: SystemBuilder
    topology: Topology
    psf: OplsPsfFile

    def refinalize(self, box=None, **kw):
        if box is None:
            box = self.psf.box
        self.system = self.builder.finalize(box, **kw)
        return self.system
