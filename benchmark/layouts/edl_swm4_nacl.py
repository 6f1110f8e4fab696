"""Tables of a constant-voltage slab: SWM4-NDP water and Drude-polarizable
NaCl between two graphite electrodes, one image charge a liquid site,
built in numpy from the configuration and the seed.

The mirror planes are z = 0 and z = Lz / 2.  Each electrode is a stack of
AB-stacked graphene layers of rectangular cells, its back layer half an
interlayer spacing in front of its plane, the two electrodes between the
planes; the liquid fills the slab between their inner layers, less the
configuration's contact distance on each side, at the solution's density.
Behind the planes, z' = Lz - z, lie the images.

Rows, in order: the electrodes (neutral, massless, layer by layer, the
bottom electrode first); the liquid (the waters in the water layout's
five-site order, then each Na+ and each Cl- with its Drude); then one image
a liquid row, in the liquid's order, massless, with the negated charge, no
Lennard-Jones and its parent's exclusions: the trailing image block that
the port's mirror route takes.  An M site's image is a virtual site on the
images of its O, H1 and H2 with M's weights, which is M's mirror since a
reflection is affine and the weights sum to 1.

Beside the water layout's keys, the tables carry the run-edl wiring: the
electrode and liquid rows, the image pairs as (parent, image), the mirror
plane, the Lennard-Jones groups (liquid 0, images 1, electrode 2) and the
pairs of groups that keep their Lennard-Jones, the Drude wall's particles,
axis, bounds and parameters, and the per-type Lennard-Jones sigma and
epsilon, which combine by the Lorentz-Berthelot rule.  ``molecule`` is -1
on the electrode, which belongs to no molecule.
"""
from __future__ import annotations

import numpy as np

from benchmark.layouts.swm4_ndp import (AVOGADRO, D, H1, H2, KCAL, M, O,
                                        SITES, geometry, molecule_positions,
                                        thermal_velocities)

# Lennard-Jones types: water oxygen, none (hydrogens, Drudes, M sites and
# images), Na+, Cl-, carbon
O_T, NONE_T, NA_T, CL_T, C_T = range(5)
# run-edl.py's groups and the pairs of groups that keep their LJ: the
# images have none with each other or with the electrode
LIQUID_G, IMAGE_G, ELECTRODE_G = range(3)
GROUP_PAIRS = ((0, 0), (0, 2), (2, 2), (1, 0))
RMIN_PER_SIGMA = 2.0 ** (1.0 / 6.0)


def graphene_layer(nx, ny, cc, shift):
    """(nx ny 4, 2) x, y of a graphene layer of nx x ny rectangular cells
    (0.246 x 0.426 nm at cc = 0.142 nm), moved by ``shift`` bonds along y:
    one bond gives the next layer of an AB stack."""
    a, b = cc * np.sqrt(3.0), 3.0 * cc
    basis = np.array([[0.0, 0.0], [0.0, cc], [0.5 * a, 1.5 * cc],
                      [0.5 * a, 2.5 * cc]])
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    cells = np.stack([ix.reshape(-1) * a, iy.reshape(-1) * b], 1)
    xy = (cells[:, None] + basis[None]).reshape(-1, 2)
    xy[:, 1] += shift * cc
    return np.mod(xy, [nx * a, ny * b])


def solution_mass(cfg):
    """The liquid's mass in grams."""
    m, ions = cfg["model"], cfg["ions"]
    per_mol = (cfg["n_waters"] * (m["o_mass"] + 2 * m["h_mass"])
               + cfg["n_ion_pairs"] * (ions["na"]["mass"]
                                       + ions["cl"]["mass"]))
    return per_mol / AVOGADRO


def slab(cfg):
    """The slab's lengths (nm): lx, ly, the liquid's thickness, the liquid's
    lower face and the mirror plane zm = Lz / 2."""
    nx, ny = cfg["electrode_cells"]
    cc, h = cfg["graphene_cc_nm"], cfg["interlayer_nm"]
    lx, ly = nx * cc * np.sqrt(3.0), ny * 3.0 * cc
    gap = solution_mass(cfg) / cfg["density_g_cm3"] * 1e21 / (lx * ly)
    inner = 0.5 * h + (cfg["electrode_layers"] - 1) * h
    z_lo = inner + cfg["contact_nm"]
    return lx, ly, gap, z_lo, 2.0 * z_lo + gap


def electrode_positions(cfg, zm):
    """(n, 3) carbons of both electrodes: layer k of each k interlayer
    spacings from its back layer, which is half a spacing from its plane."""
    nx, ny = cfg["electrode_cells"]
    cc, h = cfg["graphene_cc_nm"], cfg["interlayer_nm"]
    layers = []
    for side in (0, 1):
        for k in range(cfg["electrode_layers"]):
            z = 0.5 * h + k * h
            xy = graphene_layer(nx, ny, cc, k % 2)
            layers.append(np.concatenate(
                [xy, np.full((xy.shape[0], 1), zm - z if side else z)], 1))
    return np.concatenate(layers)


def lattice_sites(cfg, n, lx, ly, gap, z_lo, rng):
    """``n`` sites drawn from the seed out of a near-cubic lattice filling
    the liquid's slab, jittered."""
    side = (lx * ly * gap / n) ** (1.0 / 3.0)
    nx, ny = max(1, round(lx / side)), max(1, round(ly / side))
    nz = -(-n // (nx * ny))
    site = np.sort(rng.choice(nx * ny * nz, n, replace=False))
    grid = np.stack([site % nx, (site // nx) % ny, site // (nx * ny)], 1)
    centres = (grid + 0.5) * [lx / nx, ly / ny, gap / nz] + [0.0, 0.0, z_lo]
    return centres + rng.uniform(-cfg["jitter_nm"], cfg["jitter_nm"],
                                 (n, 3))


def tables(cfg, seed):
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    model, ions = cfg["model"], cfg["ions"]
    n_w, n_p = int(cfg["n_waters"]), int(cfg["n_ion_pairs"])
    lx, ly, gap, z_lo, zm = slab(cfg)

    # the liquid: species drawn onto lattice sites, listed in blocks
    centres = lattice_sites(cfg, n_w + 2 * n_p, lx, ly, gap, z_lo, rng)
    centres = centres[rng.permutation(centres.shape[0])]
    water = molecule_positions(centres[:n_w], model, cfg["drude_offset_nm"],
                               rng).reshape(-1, 3)
    cores = centres[n_w:]
    u = rng.standard_normal(cores.shape)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    ion_pos = np.stack([cores, cores + cfg["drude_offset_nm"] * u],
                       1).reshape(-1, 3)
    elec_pos = electrode_positions(cfg, zm)
    n_e, n_liq = elec_pos.shape[0], water.shape[0] + ion_pos.shape[0]
    liquid = n_e + np.arange(n_liq)
    image = liquid + n_liq

    # per-row tables of the liquid
    _, w_m, hh = geometry(model)
    dm = model["drude_mass"]
    w_mass = [model["o_mass"] - dm, dm, model["h_mass"], model["h_mass"],
              0.0]
    w_charge = [-model["q_drude"], model["q_drude"], model["q_h"],
                model["q_h"], model["q_m"]]
    # every Drude has the water's spring: q_D^2 / alpha is the water's
    q_d = {k: model["q_drude"] * np.sqrt(ions[k]["alpha_nm3"]
                                         / model["alpha_nm3"])
           for k in ("na", "cl")}
    masses, charges, types = [np.tile(w_mass, n_w)], \
        [np.tile(w_charge, n_w)], [np.tile([O_T] + [NONE_T] * 4, n_w)]
    for k, ty in (("na", NA_T), ("cl", CL_T)):
        masses.append(np.tile([ions[k]["mass"] - dm, dm], n_p))
        charges.append(np.tile([ions[k]["charge"] - q_d[k], q_d[k]], n_p))
        types.append(np.tile([ty, NONE_T], n_p))
    liq_mass, liq_charge, liq_type = (np.concatenate(x) for x in
                                      (masses, charges, types))

    # molecules of the liquid: waters, then the ions with their Drudes
    base = n_e + SITES * np.arange(n_w, dtype=np.int64)
    at = {k: base + k for k in range(SITES)}
    members = np.stack([at[k] for k in range(SITES)], 1)
    iu, ju = np.triu_indices(SITES, 1)
    ion_core = n_e + SITES * n_w + 2 * np.arange(2 * n_p, dtype=np.int64)
    exclusions = np.concatenate([
        np.stack([members[:, iu].reshape(-1), members[:, ju].reshape(-1)],
                 1),
        np.stack([ion_core, ion_core + 1], 1)])
    drudes = np.concatenate([np.stack([at[D], at[O]], 1),
                             np.stack([ion_core + 1, ion_core], 1)])
    alpha = np.concatenate([np.full(n_w, model["alpha_nm3"]),
                            np.full(n_p, ions["na"]["alpha_nm3"]),
                            np.full(n_p, ions["cl"]["alpha_nm3"])])
    oh = model["l_oh_nm"]
    vparents = np.stack([at[O], at[H1], at[H2]], 1)
    molecule = np.concatenate([np.repeat(np.arange(n_w), SITES),
                               np.repeat(n_w + np.arange(2 * n_p), 2)])

    # Lennard-Jones by type: sigma from R_min / 2, epsilon in kJ/mol
    sigma = np.array([2.0 * model["o_rmin_half_nm"] / RMIN_PER_SIGMA, 0.1,
                      2.0 * ions["na"]["rmin_half_nm"] / RMIN_PER_SIGMA,
                      2.0 * ions["cl"]["rmin_half_nm"] / RMIN_PER_SIGMA,
                      cfg["carbon"]["sigma_nm"]])
    epsilon = np.array([model["o_epsilon_kcal_mol"] * KCAL, 0.0,
                        ions["na"]["epsilon_kcal_mol"] * KCAL,
                        ions["cl"]["epsilon_kcal_mol"] * KCAL,
                        cfg["carbon"]["epsilon_kj_mol"]])
    liq_pos = np.concatenate([water, ion_pos])
    img_pos = liq_pos * [1.0, 1.0, -1.0] + [0.0, 0.0, 2.0 * zm]
    groups = np.concatenate([np.full(n_e, ELECTRODE_G),
                             np.full(n_liq, LIQUID_G),
                             np.full(n_liq, IMAGE_G)])
    out = dict(
        masses=np.concatenate([np.zeros(n_e), liq_mass, np.zeros(n_liq)]),
        charges=np.concatenate([np.zeros(n_e), liq_charge, -liq_charge]),
        lj_type=np.concatenate([np.full(n_e, C_T), liq_type,
                                np.full(n_liq, NONE_T)]),
        lj_sigma=sigma, lj_epsilon=epsilon,
        # the images carry their parents' exclusions
        exclusions=np.concatenate([exclusions, exclusions + n_liq]),
        drudes=drudes,
        drude_charge=np.concatenate([np.full(n_w, model["q_drude"]),
                                     np.full(n_p, q_d["na"]),
                                     np.full(n_p, q_d["cl"])]),
        drude_alpha=alpha,
        constraints=np.concatenate([np.stack([at[O], at[H1]], 1),
                                    np.stack([at[O], at[H2]], 1),
                                    np.stack([at[H1], at[H2]], 1)]),
        constraint_nm=np.concatenate([np.full(2 * n_w, oh),
                                      np.full(n_w, hh)]),
        # the M sites, then their images on the images of their parents
        vsites=np.concatenate([at[M], at[M] + n_liq]),
        vsite_parents=np.concatenate([vparents, vparents + n_liq]),
        vsite_weights=np.tile(np.asarray(w_m), (2 * n_w, 1)),
        molecule=np.concatenate([np.full(n_e, -1), molecule, molecule]),
        positions=np.concatenate([elec_pos, liq_pos, img_pos]).astype(
            np.float32),
        box=np.array([lx, ly, 2.0 * zm]), cutoff=float(cfg["cutoff_nm"]),
        ewald_tolerance=float(cfg["ewald_tolerance"]),
        integrator=dict(cfg["integrator"]),
        electrode=np.arange(n_e), liquid=liquid,
        image_pairs=np.stack([liquid, image], 1), mirror_nm=zm,
        lj_group=groups, lj_group_pairs=np.array(GROUP_PAIRS),
        wall=dict(particles=drudes[:, 0], axis=2, bound=(0.0, zm),
                  epsilon=cfg["wall"]["epsilon_kcal_mol"] * KCAL,
                  sigma=cfg["wall"]["sigma_nm"]))
    out["velocities"] = thermal_velocities(out["masses"],
                                           cfg["velocity_temperature"], rng)
    return out
