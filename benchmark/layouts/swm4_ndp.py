"""Tables of a box of SWM4-NDP water, built in numpy from the configuration
and the seed.

Each molecule is five sites: the oxygen core, its Drude particle (which
carries the negative charge of the model's name), two hydrogens and the
massless M site.  It is rigid: three constraints (O-H, O-H, H-H) hold it,
M is the average of O, H1 and H2 that puts it ``l_om`` from O on the
bisector, and every intramolecular pair is excluded.  Only the oxygens
carry Lennard-Jones.  Molecules sit on a cubic lattice that fills a box
sized for the configuration's density; the sites they take are drawn from
the seed, and each molecule is moved by a seeded jitter and turned to a
seeded random orientation, its Drude a seeded short distance from its
core.  The tables are plain arrays, read alike by ``benchmark/port.py``
(which hands them to the port's SystemBuilder) and by
``benchmark/reference.py``.
"""
from __future__ import annotations

import numpy as np

BOLTZ = 8.31446261815324e-3
AVOGADRO = 6.02214076e23
KCAL = 4.184
# sites of a molecule, in order
O, D, H1, H2, M = range(5)
SITES = 5


def geometry(model):
    """(H offsets in the molecule's frame (2, 3), the M site's weights on
    O, H1, H2, the H-H distance), all from the model's lengths and angle."""
    oh, half = model["l_oh_nm"], 0.5 * np.radians(model["theta_hoh_deg"])
    hyd = np.array([[oh * np.cos(half), oh * np.sin(half), 0.0],
                    [oh * np.cos(half), -oh * np.sin(half), 0.0]])
    w_h = model["l_om_nm"] / (2.0 * oh * np.cos(half))
    return hyd, (1.0 - 2.0 * w_h, w_h, w_h), 2.0 * oh * np.sin(half)


def box_edge(cfg):
    """The cube's edge (nm) that holds the molecules at the density."""
    m = cfg["model"]
    grams = cfg["n_molecules"] * (m["o_mass"] + 2 * m["h_mass"]) / AVOGADRO
    return (grams / cfg["density_g_cm3"] * 1e21) ** (1.0 / 3.0)


def random_rotations(n, rng):
    """(n, 3, 3) rotation matrices of uniformly random orientation (from
    normalised Gaussian quaternions)."""
    q = rng.standard_normal((n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], 1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], 1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], 1)], 1)


def molecule_positions(centres, model, drude_offset, rng):
    """(n, 5, 3) positions of molecules with their oxygens at ``centres``,
    in seeded random orientations, each Drude ``drude_offset`` from its
    core in a seeded random direction."""
    n = centres.shape[0]
    hyd_body, w, _ = geometry(model)
    hyd = centres[:, None] + np.einsum("nij,kj->nki",
                                       random_rotations(n, rng), hyd_body)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    m_site = w[0] * centres + w[1] * hyd[:, 0] + w[2] * hyd[:, 1]
    return np.concatenate([centres[:, None],
                           (centres + drude_offset * u)[:, None], hyd,
                           m_site[:, None]], 1)


def thermal_velocities(masses, temperature, rng):
    """Maxwell-Boltzmann float32 velocities; zero for massless particles."""
    m = np.asarray(masses, np.float64)
    sigma = np.sqrt(BOLTZ * temperature / np.where(m > 0, m, 1.0))
    v = sigma[:, None] * rng.standard_normal((m.shape[0], 3))
    return np.where(m[:, None] > 0, v, 0.0).astype(np.float32)


def tables(cfg, seed):
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    model = cfg["model"]
    n_mol = int(cfg["n_molecules"])
    edge = box_edge(cfg)
    side = int(np.ceil(n_mol ** (1.0 / 3.0) - 1e-9))
    spacing = edge / side
    site = np.sort(rng.choice(side ** 3, n_mol, replace=False))
    grid = np.stack([site % side, (site // side) % side,
                     site // (side * side)], 1)
    centres = (grid + 0.5) * spacing + rng.uniform(
        -cfg["jitter_nm"], cfg["jitter_nm"], (n_mol, 3))
    pos = molecule_positions(centres, model, cfg["drude_offset_nm"], rng)

    _, w_m, hh = geometry(model)
    base = SITES * np.arange(n_mol, dtype=np.int64)
    at = {k: base + k for k in range(SITES)}
    mass = np.array([model["o_mass"] - model["drude_mass"],
                     model["drude_mass"], model["h_mass"], model["h_mass"],
                     0.0])
    charge = np.array([-model["q_drude"], model["q_drude"], model["q_h"],
                       model["q_h"], model["q_m"]])
    iu, ju = np.triu_indices(SITES, 1)
    members = np.stack([at[k] for k in range(SITES)], 1)
    oh = model["l_oh_nm"]
    out = dict(
        masses=np.tile(mass, n_mol), charges=np.tile(charge, n_mol),
        lj_type=np.tile([0, 1, 1, 1, 1], n_mol),
        # sigma from R_min / 2, epsilon from kcal/mol
        lj_sigma=np.array([2.0 * model["o_rmin_half_nm"] / 2.0 ** (1 / 6),
                           0.1]),
        lj_epsilon=np.array([model["o_epsilon_kcal_mol"] * KCAL, 0.0]),
        exclusions=np.stack([members[:, iu].reshape(-1),
                             members[:, ju].reshape(-1)], 1),
        drudes=np.stack([at[D], at[O]], 1),
        drude_charge=np.full(n_mol, model["q_drude"]),
        drude_alpha=np.full(n_mol, model["alpha_nm3"]),
        # three blocks of constraints, no two in a block sharing an atom
        constraints=np.concatenate([np.stack([at[O], at[H1]], 1),
                                    np.stack([at[O], at[H2]], 1),
                                    np.stack([at[H1], at[H2]], 1)]),
        constraint_nm=np.concatenate([np.full(2 * n_mol, oh),
                                      np.full(n_mol, hh)]),
        vsites=at[M], vsite_parents=np.stack([at[O], at[H1], at[H2]], 1),
        vsite_weights=np.tile(np.asarray(w_m), (n_mol, 1)),
        molecule=np.repeat(np.arange(n_mol), SITES),
        positions=pos.reshape(-1, 3).astype(np.float32),
        box=np.full(3, edge), cutoff=float(cfg["cutoff_nm"]),
        ewald_tolerance=float(cfg["ewald_tolerance"]),
        integrator=dict(cfg["integrator"]))
    out["velocities"] = thermal_velocities(out["masses"],
                                           cfg["velocity_temperature"], rng)
    return out
