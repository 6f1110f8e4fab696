"""Tables of a CL&Pol ionic liquid, [C2C1im][DCA] with a Drude on every
heavy atom, built in numpy from the configuration and the seed.

Each ion is laid out from its template in the configuration: its atoms in
the template's order, each heavy atom followed at once by its Drude, so an
ion's sites are one contiguous block (27 a cation, 10 an anion); the
cations come first, then the anions.  From the template's bonds come, as
``oplspsffile.py`` builds them: the flexible bonds and the constraints of
the bonds to hydrogen; every angle and torsion of the bond graph, its
constants looked up by the atoms' types (a torsion of all-zero constants
left out); the 1-2, 1-3 and 1-4 pairs of atoms; the Thole pairs (the 1-2
and 1-3 pairs of polarizable atoms); and the exclusions: each 1-2, 1-3 and
1-4 pair with the Drudes of its two atoms, and each core with its Drude.
The 1-4 pairs are listed as pairs of atoms; the wiring and the reference
each make their scaled interactions from them.

Lennard-Jones is by atom type (Drudes take a type of their own with none);
``lj_k`` holds CL&Pol's scaling k_ij of epsilon by pair of types.  Units
are the port's: nm, kJ/mol, e, amu, rad.

The start is the configuration's ``start``: a file of positions and box
(the full size), shifted rigidly by a seeded vector in the periodic box, or
``"lattice"``: a cubic lattice at ``lattice_density_g_cm3`` with the ions
drawn onto its sites, each built from its z-matrix and turned to a seeded
orientation that keeps its atoms ``lattice_gap_nm`` from those of the ions
placed before it.  The box of the file must hold the configuration's
density: the layout checks it.
"""
from __future__ import annotations

import os

import numpy as np

from benchmark.layouts.swm4_ndp import (AVOGADRO, BOLTZ, random_rotations,
                                        thermal_velocities)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
ONE_4PI_EPS0 = 138.935456
# per A^2 to per nm^2, A to nm
PER_A2, NM = 100.0, 0.1
# the order of the ion blocks in the tables
IONS = ("c2c1im", "dca")
# the most orientations drawn for one ion of the lattice start
TRIES = 500


def _key(types):
    """A symmetric lookup key: the types or their reverse, whichever
    sorts first."""
    types = tuple(types)
    return min(types, types[::-1])


class ForceField:
    """The configuration's per-type tables."""

    def __init__(self, cfg):
        self.types = list(cfg["atom_types"])
        self.type_index = {name: k for k, name in enumerate(self.types)}
        self.atom = cfg["atom_types"]
        self.bond = {_key(r[:2]): (r[2] * NM, r[3] * PER_A2)
                     for r in cfg["bonds"]}
        self.angle = {_key(r[:3]): (np.radians(r[3]), r[4])
                      for r in cfg["angles"]}
        self.torsion = {_key(r[:4]): tuple(r[4:8]) for r in cfg["torsions"]}
        # improper: the central (third) atom's type and the other three's
        self.improper = {(r[2], tuple(sorted((r[0], r[1], r[3])))): r[4]
                         for r in cfg["impropers"]}
        d = cfg["drude"]
        self.drude_mass = d["mass"]
        self.k_drude = d["k_kj_mol_a2"] * PER_A2
        self.alpha = {e: a * NM ** 3 for e, a in d["alpha_a3"].items()}

    def lookup(self, table, types, what):
        try:
            return table[_key(types)]
        except KeyError:
            raise KeyError(f"no {what} parameters for {types}") from None


class IonTemplate:
    """One ion's sites and terms, indexed from its first site."""

    def __init__(self, ff, tmpl):
        atoms = tmpl["atoms"]
        self.names = [a for a, _ in atoms]
        self.types = [t for _, t in atoms]
        at = {a: k for k, a in enumerate(self.names)}
        h = [ff.atom[t]["element"] == "H" for t in self.types]
        # sites: each heavy atom followed by its Drude
        self.site, self.drude = [], []
        n = 0
        for k in range(len(atoms)):
            self.site.append(n)
            self.drude.append(None if h[k] else n + 1)
            n += 1 if h[k] else 2
        self.n_sites = n
        # the polarizability of each heavy atom with its hydrogens'
        nbr = [set() for _ in atoms]
        bonds = [(at[a], at[b]) for a, b in tmpl["bonds"]]
        for a, b in bonds:
            nbr[a].add(b)
            nbr[b].add(a)
        self.alpha = [None if h[k] else ff.alpha[ff.atom[t]["element"]]
                      + ff.alpha["H"] * sum(h[j] for j in nbr[k])
                      for k, t in enumerate(self.types)]
        self.q_drude = [None if a is None else
                        -np.sqrt(ff.k_drude * a / ONE_4PI_EPS0)
                        for a in self.alpha]
        mass, charge, ltype = [], [], []
        drude_t = len(ff.types)
        for k, t in enumerate(self.types):
            m, q = ff.atom[t]["mass"], ff.atom[t]["charge"]
            if self.drude[k] is None:
                mass.append(m)
                charge.append(q)
                ltype.append(ff.type_index[t])
            else:
                qd = self.q_drude[k]
                mass += [m - ff.drude_mass, ff.drude_mass]
                charge += [q - qd, qd]
                ltype += [ff.type_index[t], drude_t]
        self.mass, self.charge = np.array(mass), np.array(charge)
        self.lj_type = np.array(ltype)
        self.atom_mass = sum(ff.atom[t]["mass"] for t in self.types)

        # the bonded terms, on sites
        s = self.site
        self.bonds, self.bond_prm, self.cons, self.cons_nm = [], [], [], []
        for a, b in bonds:
            r0, k = ff.lookup(ff.bond, (self.types[a], self.types[b]),
                              "bond")
            if h[a] or h[b]:
                self.cons.append((s[a], s[b]))
                self.cons_nm.append(r0)
            else:
                self.bonds.append((s[a], s[b]))
                self.bond_prm.append((r0, k))
        self.angles, self.angle_prm = [], []
        for j in range(len(atoms)):
            for i in sorted(nbr[j]):
                for k in sorted(nbr[j]):
                    if i < k:
                        self.angles.append((s[i], s[j], s[k]))
                        self.angle_prm.append(ff.lookup(
                            ff.angle, [self.types[x] for x in (i, j, k)],
                            "angle"))
        self.torsions, self.torsion_v = [], []
        p12 = {tuple(sorted(b)) for b in bonds}
        p13, p14 = set(), set()
        for b, c in bonds:
            for a in sorted(nbr[b] - {c}):
                p13.add(tuple(sorted((a, c))))
            for d in sorted(nbr[c] - {b}):
                p13.add(tuple(sorted((b, d))))
            for a in sorted(nbr[b] - {c}):
                for d in sorted(nbr[c] - {b}):
                    if a == d:
                        continue
                    p14.add(tuple(sorted((a, d))))
                    v = ff.lookup(ff.torsion,
                                  [self.types[x] for x in (a, b, c, d)],
                                  "torsion")
                    if any(v):
                        self.torsions.append((s[a], s[b], s[c], s[d]))
                        self.torsion_v.append(v)
        p13 -= p12
        p14 -= p12 | p13
        self.impropers, self.improper_v2 = [], []
        for i, j, k, l in tmpl["impropers"]:
            i, j, k, l = at[i], at[j], at[k], at[l]
            key = (self.types[k], tuple(sorted(self.types[x]
                                               for x in (i, j, l))))
            if key not in ff.improper:
                raise KeyError(f"no improper parameters for {key}")
            # oplspsffile.py takes the dihedral of (j, k, i, l)
            self.impropers.append((s[j], s[k], s[i], s[l]))
            self.improper_v2.append(ff.improper[key])

        def with_drudes(a):
            return [s[a]] + ([] if self.drude[a] is None else [self.drude[a]])
        self.thole = [(s[a], s[b]) for a, b in sorted(p12 | p13)
                      if self.drude[a] is not None
                      and self.drude[b] is not None]
        self.pairs14 = [(s[a], s[b]) for a, b in sorted(p14)]
        excl = set()
        for a, b in sorted(p12 | p13 | p14):
            for x in with_drudes(a):
                for y in with_drudes(b):
                    excl.add((min(x, y), max(x, y)))
        for k in range(len(atoms)):
            if self.drude[k] is not None:
                excl.add((s[k], self.drude[k]))
        self.exclusions = sorted(excl)
        self.drudes = [(self.drude[k], s[k], self.q_drude[k], self.alpha[k])
                       for k in range(len(atoms)) if self.drude[k] is not None]
        self.zmatrix = tmpl["zmatrix"]
        self.at = at
        self.ff = ff

    def geometry(self):
        """(atoms, 3) positions from the z-matrix at the bonds' r0 and the
        angles' theta0, centred on their mean."""
        ff, t = self.ff, self.types
        x = np.zeros((len(self.names), 3))
        placed = set()
        for row in self.zmatrix:
            a = self.at[row[0]]
            if len(row) == 1:
                x[a] = 0.0
            else:
                b = self.at[row[1]]
                r = ff.lookup(ff.bond, (t[a], t[b]), "bond")[0]
                if len(row) == 2:
                    x[a] = x[b] + [r, 0.0, 0.0]
                else:
                    c = self.at[row[2]]
                    th = ff.lookup(ff.angle, (t[a], t[b], t[c]), "angle")[0]
                    if len(row) == 3:
                        u = x[c] - x[b]
                        u /= np.linalg.norm(u)
                        v = np.cross(u, [0.0, 0.0, 1.0])
                        v /= np.linalg.norm(v)
                        x[a] = x[b] + r * (np.cos(th) * u + np.sin(th) * v)
                    else:
                        d = self.at[row[3]]
                        x[a] = _place(x[d], x[c], x[b], r, th,
                                      np.radians(row[4]))
            placed.add(a)
        if len(placed) != len(self.names):
            raise ValueError(f"the z-matrix places {sorted(placed)} of "
                             f"{len(self.names)} atoms")
        return x - x.mean(0)


def _place(a, b, c, r, theta, phi):
    """The point d with |d - c| = r, angle (b, c, d) = theta and dihedral
    (a, b, c, d) = phi."""
    bc = c - b
    bc /= np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    d2 = np.array([-r * np.cos(theta), r * np.sin(theta) * np.cos(phi),
                   r * np.sin(theta) * np.sin(phi)])
    return c + d2[0] * bc + d2[1] * m + d2[2] * n


def templates(cfg):
    ff = ForceField(cfg)
    return ff, [IonTemplate(ff, cfg["ions"][name]) for name in IONS]


def box_edge(cfg, density):
    """The cube's edge (nm) that holds the ion pairs at ``density``
    (g/cm3)."""
    _, tmpls = templates(cfg)
    grams = cfg["n_ion_pairs"] * sum(t.atom_mass for t in tmpls) / AVOGADRO
    return (grams / density * 1e21) ** (1.0 / 3.0)


def lattice_start(cfg, tmpls, rng):
    """(sites, 3) positions and the box of the lattice start: see the
    module doc."""
    n_pairs = int(cfg["n_ion_pairs"])
    edge = box_edge(cfg, cfg["lattice_density_g_cm3"])
    n_ions = 2 * n_pairs
    side = int(np.ceil(n_ions ** (1.0 / 3.0) - 1e-9))
    spacing = edge / side
    site = rng.choice(side ** 3, n_ions, replace=False)
    grid = np.stack([site % side, (site // side) % side,
                     site // (side * side)], 1)
    centres = (grid + 0.5) * spacing
    gap2 = cfg["lattice_gap_nm"] ** 2
    shapes = [t.geometry() for t in tmpls]
    placed = np.zeros((0, 3))
    blocks = []
    for k in range(n_ions):
        tmpl, shape = ((tmpls[0], shapes[0]) if k < n_pairs
                       else (tmpls[1], shapes[1]))
        for _ in range(TRIES):
            x = centres[k] + shape @ random_rotations(1, rng)[0].T
            d = x[:, None, :] - placed[None, :, :]
            d -= edge * np.round(d / edge)
            if not placed.size or np.min(np.sum(d * d, -1)) > gap2:
                break
        else:
            raise RuntimeError(f"no orientation of ion {k} keeps "
                               f"{cfg['lattice_gap_nm']} nm from the others")
        placed = np.concatenate([placed, x])
        sites = np.zeros((tmpl.n_sites, 3))
        for a, s in enumerate(tmpl.site):
            sites[s] = x[a]
            if tmpl.drude[a] is not None:
                u = rng.standard_normal(3)
                sites[tmpl.drude[a]] = x[a] + cfg["drude_offset_nm"] * (
                    u / np.linalg.norm(u))
        blocks.append(sites)
    return np.concatenate(blocks), np.full(3, edge)


def file_start(cfg, offsets, sizes, rng):
    """Positions and box of the configuration's start file, the whole
    configuration moved by a seeded vector and each ion put back into the
    box by its first site."""
    with np.load(os.path.join(ROOT, cfg["start"])) as f:
        pos, box = f["positions"].astype(np.float64), f["box"]
    edge = box_edge(cfg, cfg["density_g_cm3"])
    if pos.shape[0] != offsets[-1] + sizes[-1] or not np.allclose(
            box, edge, rtol=1e-6):
        raise ValueError(f"{cfg['start']} holds {pos.shape[0]} sites in a "
                         f"box {box}, not the configuration's "
                         f"{offsets[-1] + sizes[-1]} sites in a {edge:.6f}-nm "
                         f"cube")
    pos = pos + rng.uniform(0.0, 1.0, 3) * box
    for o, n in zip(offsets, sizes):
        pos[o:o + n] -= box * np.floor(pos[o] / box)
    return pos, box


def tables(cfg, seed):
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    ff, tmpls = templates(cfg)
    n_pairs = int(cfg["n_ion_pairs"])
    order = [tmpls[0]] * n_pairs + [tmpls[1]] * n_pairs
    sizes = np.array([t.n_sites for t in order])
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    if cfg["start"] == "lattice":
        pos, box = lattice_start(cfg, tmpls, rng)
    else:
        pos, box = file_start(cfg, offsets, sizes, rng)

    def cat(attr, width=None):
        rows = []
        for o, t in zip(offsets, order):
            a = np.asarray(getattr(t, attr), np.int64)
            rows.append(a.reshape(-1, width) + o if width else a)
        return np.concatenate(rows)

    def tile(attr, width=None):
        return np.concatenate([np.asarray(getattr(t, attr), np.float64)
                               .reshape((-1, width) if width else (-1,))
                               for t in order])

    drudes = np.concatenate([np.array([(d, p) for d, p, _, _ in t.drudes],
                                      np.int64) + o
                             for o, t in zip(offsets, order)])
    q_d = np.concatenate([[q for _, _, q, _ in t.drudes] for t in order])
    alpha = np.concatenate([[a for _, _, _, a in t.drudes] for t in order])
    n_types = len(ff.types)
    sigma = np.array([ff.atom[t]["sigma_a"] * NM for t in ff.types] + [0.1])
    epsilon = np.array([ff.atom[t]["epsilon_kj_mol"] for t in ff.types]
                       + [0.0])
    frag = [ff.atom[t]["fragment"] for t in ff.types]
    k_frag = {}
    for a, b, k in cfg["k_ij"]:
        k_frag[(a, b)] = k_frag[(b, a)] = k
    lj_k = np.ones((n_types + 1, n_types + 1))
    for i in range(n_types):
        for j in range(n_types):
            lj_k[i, j] = k_frag[(frag[i], frag[j])]
    masses = tile("mass")
    out = dict(
        masses=masses, charges=tile("charge"), lj_type=tile("lj_type")
        .astype(np.int64), lj_sigma=sigma, lj_epsilon=epsilon, lj_k=lj_k,
        exclusions=cat("exclusions", 2), drudes=drudes, drude_charge=q_d,
        drude_alpha=alpha, constraints=cat("cons", 2),
        constraint_nm=tile("cons_nm"),
        vsites=np.zeros(0, np.int64), vsite_parents=np.zeros((0, 3), np.int64),
        vsite_weights=np.zeros((0, 3)),
        molecule=np.repeat(np.arange(2 * n_pairs), sizes),
        bonds=cat("bonds", 2), bond_r0=tile("bond_prm", 2)[:, 0],
        bond_k=tile("bond_prm", 2)[:, 1],
        angles=cat("angles", 3), angle_theta0=tile("angle_prm", 2)[:, 0],
        angle_k=tile("angle_prm", 2)[:, 1],
        torsions=cat("torsions", 4), torsion_v=tile("torsion_v", 4),
        impropers=cat("impropers", 4), improper_v2=tile("improper_v2"),
        thole_pairs=cat("thole", 2), thole_a=float(cfg["drude"]["thole_a"]),
        pairs14=cat("pairs14", 2),
        scale14_coulomb=float(cfg["scale14"]["coulomb"]),
        scale14_lj=float(cfg["scale14"]["lj"]),
        ion_sites=np.stack([offsets, sizes], 1),
        positions=pos.astype(np.float32), box=np.asarray(box, np.float64),
        cutoff=float(cfg["cutoff_nm"]),
        ewald_tolerance=float(cfg["ewald_tolerance"]),
        integrator=dict(cfg["integrator"]))
    # Maxwell-Boltzmann: each Drude pair's centre of mass at the
    # temperature, its relative motion at the Drudes'
    vel = thermal_velocities(masses, cfg["velocity_temperature"],
                             rng).astype(np.float64)
    d, p = drudes[:, 0], drudes[:, 1]
    md, mp = masses[d, None], masses[p, None]
    v_cm = (md * vel[d] + mp * vel[p]) / (md + mp)
    mu = md * mp / (md + mp)
    v_rel = np.sqrt(BOLTZ * cfg["integrator"]["drude_temperature"]
                    / mu) * rng.standard_normal((d.size, 3))
    vel[d] = v_cm + mp / (md + mp) * v_rel
    vel[p] = v_cm - md / (md + mp) * v_rel
    out["velocities"] = vel.astype(np.float32)
    return out
