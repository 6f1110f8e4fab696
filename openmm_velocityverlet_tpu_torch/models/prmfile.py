"""CHARMM parameter (.prm) file parser (counterpart of
``openmm_velocityverlet_tpu/models/prmfile.py``, pure Python, the same
code) — the subset of CharmmParameterSet the reference workloads consume
(examples/models/*/ff.prm; conventions documented in those files' comment
headers):

* ATOMS      : MASS index name mass
* BONDS      : t1 t2 Kb b0                (kcal/mol/A^2, A)
* ANGLES     : t1 t2 t3 Ktheta Theta0 [Kub S0]
* DIHEDRALS  : t1 t2 t3 t4 Kchi n delta   (kcal/mol, -, deg); multi-term ok
* IMPROPERS  : t1 t2 t3 t4 Kpsi ignored psi0
* NONBONDED  : t ignored -eps Rmin/2 ignored -eps14 Rmin14/2
* NBFIX      : t1 t2 -eps Rmin -eps14 Rmin14   (pair Rmin, not /2)
* NBTHOLE    : t1 t2 a                    (pair Thole screening)

All values are kept in CHARMM units here; conversion to MD units happens in
the system builder (mirroring the reference split between CharmmParameterSet
and OplsPsfFile.createSystem).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class AtomType:
    name: str
    mass: float = 0.0
    epsilon: float = 0.0      # kcal/mol, positive
    rmin_half: float = 0.0    # A (Rmin/2)
    epsilon_14: float = 0.0
    rmin_14_half: float = 0.0
    nbfix: Dict[str, Tuple[float, float, float, float]] = field(
        default_factory=dict)  # other -> (eps, rmin_pair, eps14, rmin14_pair)
    nbthole: Dict[str, float] = field(default_factory=dict)


_SECTION_NAMES = {"ATOMS", "BONDS", "ANGLES", "DIHEDRALS", "IMPROPER",
                  "IMPROPERS", "NONBONDED", "NBFIX", "NBTHOLE", "CMAP",
                  "HBOND", "END"}


class CharmmParameterSet:
    def __init__(self, *filenames):
        self.atom_types: Dict[str, AtomType] = {}
        self.bond_types: Dict[tuple, Tuple[float, float]] = {}
        self.angle_types: Dict[tuple, Tuple[float, float]] = {}
        self.urey_bradley_types: Dict[tuple, Tuple[float, float]] = {}
        self.dihedral_types: Dict[tuple, List[Tuple[float, int, float]]] = {}
        self.improper_types: Dict[tuple, Tuple[float, float]] = {}
        # canonical 8-type key -> (resolution, (R,R) grid in kcal/mol,
        # phi rows / psi columns, both starting at -180 deg)
        self.cmap_types: Dict[tuple, tuple] = {}
        self._cmap_cur = None
        for fn in filenames:
            self._read(fn)

    def _read(self, filename):
        section = None
        with open(filename) as f:
            for raw in f:
                line = raw.split("!")[0].strip()
                if not line or line.startswith("*"):
                    continue
                word0 = line.split()[0].upper()
                if word0 in _SECTION_NAMES:
                    self._finish_cmap()
                    section = "IMPROPERS" if word0 == "IMPROPER" else word0
                    if section == "END":
                        section = None
                    continue
                if word0.startswith("NONB"):   # NONBONDED with options
                    section = "NONBONDED"
                    continue
                if word0 in ("CUTNB", "CTOFNB", "CTONNB", "EPS", "E14FAC",
                             "WMIN"):
                    continue
                w = line.split()
                if section == "ATOMS":
                    if w[0].upper() == "MASS":
                        self._get_type(w[2]).mass = float(w[3])
                elif section == "BONDS":
                    key = (min(w[0], w[1]), max(w[0], w[1]))
                    self.bond_types[key] = (float(w[2]), float(w[3]))
                elif section == "ANGLES":
                    key = (min(w[0], w[2]), w[1], max(w[0], w[2]))
                    self.angle_types[key] = (float(w[3]), float(w[4]))
                    if len(w) >= 7:
                        self.urey_bradley_types[key] = (float(w[5]), float(w[6]))
                elif section == "DIHEDRALS":
                    key = min((w[0], w[1], w[2], w[3]), (w[3], w[2], w[1], w[0]))
                    term = (float(w[4]), int(w[5]), float(w[6]))
                    terms = self.dihedral_types.setdefault(key, [])
                    # same multiplicity replaces, new multiplicity appends
                    terms[:] = [t for t in terms if t[1] != term[1]] + [term]
                elif section == "IMPROPERS":
                    key = min((w[0], w[1], w[2], w[3]), (w[3], w[2], w[1], w[0]))
                    self.improper_types[key] = (float(w[4]), float(w[6]))
                elif section == "NONBONDED":
                    t = self._get_type(w[0])
                    t.epsilon = abs(float(w[2]))
                    t.rmin_half = float(w[3])
                    if len(w) >= 7:
                        t.epsilon_14 = abs(float(w[5]))
                        t.rmin_14_half = float(w[6])
                    else:
                        t.epsilon_14 = t.epsilon
                        t.rmin_14_half = t.rmin_half
                elif section == "NBFIX":
                    eps = abs(float(w[2]))
                    rmin = float(w[3])
                    eps14 = abs(float(w[4])) if len(w) > 4 else eps
                    rmin14 = float(w[5]) if len(w) > 5 else rmin
                    self._get_type(w[0]).nbfix[w[1]] = (eps, rmin, eps14, rmin14)
                    self._get_type(w[1]).nbfix[w[0]] = (eps, rmin, eps14, rmin14)
                elif section == "NBTHOLE":
                    a = float(w[2])
                    self._get_type(w[0]).nbthole[w[1]] = a
                    self._get_type(w[1]).nbthole[w[0]] = a
                elif section == "CMAP":
                    # header = 8 type names + grid resolution; anything
                    # numeric is grid data for the current entry
                    try:
                        vals = [float(x) for x in w]
                    except ValueError:
                        if len(w) != 9:
                            raise ValueError(
                                f"CMAP header needs 8 types + resolution, "
                                f"got {line!r}")
                        self._finish_cmap()
                        self._cmap_cur = (tuple(t.upper() for t in w[:8]),
                                          int(w[8]), [])
                    else:
                        if self._cmap_cur is None:
                            raise ValueError(
                                "CMAP grid data before any CMAP header")
                        self._cmap_cur[2].extend(vals)
        self._finish_cmap()

    def _finish_cmap(self):
        if self._cmap_cur is None:
            return
        types, res, vals = self._cmap_cur
        self._cmap_cur = None
        if len(vals) != res * res:
            raise ValueError(
                f"CMAP {types}: expected {res * res} grid values, "
                f"got {len(vals)}")
        import numpy as np
        grid = np.asarray(vals, np.float64).reshape(res, res)
        self.cmap_types[self._cmap_key(*types)] = (res, grid)

    @staticmethod
    def _cmap_key(t1, t2, t3, t4, t5, t6, t7, t8):
        """Per-dihedral canonicalization, no wildcards
        (oplspsffile.py:703-706)."""
        k1 = min((t1, t2, t3, t4), (t4, t3, t2, t1))
        k2 = min((t5, t6, t7, t8), (t8, t7, t6, t5))
        return k1 + k2

    def _get_type(self, name) -> AtomType:
        if name not in self.atom_types:
            self.atom_types[name] = AtomType(name)
        return self.atom_types[name]

    # lookup helpers with the same fallback rules as the reference loader
    # (oplspsffile.py:628-692)
    def bond(self, t1, t2):
        return self.bond_types[(min(t1, t2), max(t1, t2))]

    def angle(self, t1, t2, t3):
        key = (min(t1, t3), t2, max(t1, t3))
        return self.angle_types[key], self.urey_bradley_types.get(key)

    def dihedral(self, t1, t2, t3, t4):
        key = min((t1, t2, t3, t4), (t4, t3, t2, t1))
        if key not in self.dihedral_types:
            key = min(("X", t2, t3, "X"), ("X", t3, t2, "X"))
        return self.dihedral_types[key]

    def cmap(self, *types8):
        """(resolution, (R,R) kcal/mol grid) for an 8-type cross-term;
        no wildcard fallback (oplspsffile.py:692-710)."""
        key = self._cmap_key(*(t.upper() for t in types8))
        if key not in self.cmap_types:
            raise KeyError(f"no CMAP parameters for {types8}")
        return self.cmap_types[key]

    def improper(self, t1, t2, t3, t4):
        key = min((t1, t2, t3, t4), (t4, t3, t2, t1))
        if key in self.improper_types:
            return self.improper_types[key]
        for anchor in (t2, t3, t4):
            key = tuple(sorted([t1, anchor, "X", "X"]))
            if key in self.improper_types:
                return self.improper_types[key]
        raise KeyError(f"no improper parameters for {(t1, t2, t3, t4)}")
