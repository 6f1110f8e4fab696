"""Replicate a periodic System along the box axes (counterpart of
``openmm_velocityverlet_tpu/models/replicate.py``; host numpy on the port's
``System``).

The reference ships bulk models of 8.3k-9.8k atoms; the headline benchmark
system has ~20k atoms (BASELINE.md, bench.py).  Tiling a periodic box is the
standard way to scale an equilibrated liquid to a larger benchmark system:
every per-atom / per-term table is duplicated with index offsets, positions
are shifted by box-vector multiples, and the Ewald parameters are recomputed
for the enlarged box (kmax grows with the box length so the reciprocal-space
accuracy is preserved).

For a periodic system this is exact up to Ewald discretization: all bonded,
direct-space and LRC energies of the k-fold replica equal exactly k times the
original.
"""
from __future__ import annotations

import numpy as np

from ..ops.ewald import ewald_parameters
from ..system import System


def _off(idx, n_atoms, copy):
    """Offset an index table by copy*n_atoms, preserving -1 padding."""
    idx = np.asarray(idx)
    return np.where(idx >= 0, idx + copy * n_atoms, idx).astype(idx.dtype)


def replicate(system: System, positions, box, factors=(1, 1, 2),
              ewald_tolerance: float = 5e-4):
    """Return (system, positions, box) tiled factors[d] times along axis d."""
    fx, fy, fz = (int(f) for f in factors)
    k = fx * fy * fz
    if k == 1:
        return system, np.asarray(positions), np.asarray(box)
    if system.gb is not None:
        raise NotImplementedError(
            "replicating implicit-solvent (GB) systems is not supported"
            " — GB is a non-periodic model")
    n = system.n_atoms
    m = system.n_molecules
    box = np.asarray(box, np.float64).reshape(3)
    shifts = [box * (i, j, l)
              for i in range(fx) for j in range(fy) for l in range(fz)]
    new_box = box * (fx, fy, fz)

    pos = np.asarray(positions, np.float64)
    new_pos = np.concatenate([pos + s for s in shifts], axis=0)

    def tile(a):
        return np.concatenate([np.asarray(a)] * k, axis=0)

    def tile_idx(a):
        a = np.asarray(a)
        return np.concatenate([_off(a, n, c) for c in range(k)], axis=0)

    d = {}
    # per-atom arrays: plain tiling
    for f in ("masses", "inv_masses", "charges", "lj_type", "lj_group",
              "nbt_idx", "nbt_alpha", "tt_charges", "tt_dipole_mask"):
        d[f] = tile(getattr(system, f))
    # per-term parameter arrays: plain tiling
    for f in ("bond_r0", "bond_k", "angle_theta0", "angle_k", "ub_r0", "ub_k",
              "dihedral_n", "dihedral_phase", "dihedral_k", "improper_k",
              "exc_qq", "exc_c6", "exc_c12", "constraint_dist",
              "vsite_origin_w", "vsite_x_w", "vsite_y_w", "vsite_local",
              "drude_k3", "drude_k1", "drude_k2", "thole_qq", "thole_screen",
              "mol_masses", "mol_inv_masses"):
        d[f] = tile(getattr(system, f))
    # atom-index tables: tile with offsets
    for f in ("bonds", "angles", "ub_bonds", "dihedrals", "impropers",
              "exclusions", "exc_idx", "constraints", "vsite_index",
              "vsite_parents", "drude_pairs", "drude_aniso", "thole_sites",
              "tt_donors", "mol_table", "cmap_atoms"):
        d[f] = tile_idx(getattr(system, f))
    d["cmap_map"] = tile(system.cmap_map)           # map ids are shared
    # molecule ids offset by the molecule count per copy
    pm = np.asarray(system.particle_mol_id)
    d["particle_mol_id"] = np.concatenate(
        [pm + c * m for c in range(k)], axis=0).astype(np.int32)
    # dispersion coefficients are sums over N_i*N_j type-count products
    d["disp_coef_a2"] = np.float32(float(system.disp_coef_a2) * k * k)
    d["disp_coef_b"] = np.float32(float(system.disp_coef_b) * k * k)
    # shared tables / scalars unchanged
    for f in ("acoef", "bcoef", "lj_group_allowed", "nbt_coef",
              "tt_b", "tt_cutoff", "cmap_coeffs", "cmap_res"):
        d[f] = getattr(system, f)
    statics = dict(
        r_cutoff=system.r_cutoff,
        use_dispersion_correction=system.use_dispersion_correction,
        has_cm_motion_remover=system.has_cm_motion_remover)
    if system.ewald_beta > 0:
        beta, kmax = ewald_parameters(system.r_cutoff, ewald_tolerance,
                                      new_box)
        statics["ewald_beta"] = float(beta)
        statics["kmax"] = tuple(kmax)
    else:
        statics["ewald_beta"] = 0.0
        statics["kmax"] = (0, 0, 0)
    new_system = System(**d, **statics)
    return new_system, new_pos.astype(np.float32), new_box.astype(np.float32)
