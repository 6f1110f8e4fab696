"""Closed-form bonded energies: bond, angle, Urey-Bradley, dihedral and
improper (counterpart of ``openmm_velocityverlet_tpu/ops/bonded.py``).

The CHARMM forms of the reference builder (oplspsffile.py:1000-1133):

* bond / UB:  E = 0.5 k (r - r0)^2
* angle:      E = 0.5 k (theta - theta0)^2
* dihedral:   E = k (1 + cos(n phi - delta))
* improper:   E = k (1 - cos(2 theta))   (OPLS, atoms pre-ordered)

Energies only, differentiable in ``pos`` (forces by ``torch.autograd``),
with minimum-image displacements; index tables are padded with -1 and
masked.  The step does not call these: its forces come from
``term_forces`` and ``mol_terms``, whose hand-derived forms they are the
oracle of; ``cmap`` takes its dihedral angle from here.
"""
from __future__ import annotations

import torch

from ..utils.pbc import minimum_image

_EPS = 1e-12


def _gather(pos, idx):
    return pos[idx.clamp(min=0)]


def _masked_sum(mask, e):
    return torch.sum(torch.where(mask, e, torch.zeros_like(e)))


def _zero(pos):
    return torch.zeros((), dtype=pos.dtype, device=pos.device)


def bond_energy(pos, box, bonds, r0, k):
    if bonds.shape[0] == 0:
        return _zero(pos)
    dr = minimum_image(_gather(pos, bonds[:, 0]) - _gather(pos, bonds[:, 1]),
                       box)
    r = torch.sqrt(torch.sum(dr * dr, -1) + _EPS)
    return _masked_sum(bonds[:, 0] >= 0, 0.5 * k * (r - r0) ** 2)


def angle_energy(pos, box, angles, theta0, k):
    if angles.shape[0] == 0:
        return _zero(pos)
    rj = _gather(pos, angles[:, 1])
    v1 = minimum_image(_gather(pos, angles[:, 0]) - rj, box)
    v2 = minimum_image(_gather(pos, angles[:, 2]) - rj, box)
    cos_t = torch.sum(v1 * v2, -1) * torch.clamp(
        1.0 / torch.sqrt(torch.sum(v1 * v1, -1) * torch.sum(v2 * v2, -1)
                         + _EPS), max=1e12)
    theta = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    return _masked_sum(angles[:, 0] >= 0, 0.5 * k * (theta - theta0) ** 2)


def _dihedral_angle(pos, box, idx):
    """Signed dihedral angle phi of (T, 4) index rows."""
    p0, p1, p2, p3 = (_gather(pos, idx[:, k]) for k in range(4))
    b1 = minimum_image(p1 - p0, box)
    b2 = minimum_image(p2 - p1, box)
    b3 = minimum_image(p3 - p2, box)
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    m1 = torch.linalg.cross(n1, b2 / torch.sqrt(
        torch.sum(b2 * b2, -1, keepdim=True) + _EPS))
    x = torch.sum(n1 * n2, -1)
    y = torch.sum(m1 * n2, -1)
    return torch.atan2(y, x + _EPS * (x == 0))


def dihedral_energy(pos, box, dihedrals, n, phase, k):
    if dihedrals.shape[0] == 0:
        return _zero(pos)
    phi = _dihedral_angle(pos, box, dihedrals)
    return _masked_sum(dihedrals[:, 0] >= 0,
                       k * (1.0 + torch.cos(n * phi - phase)))


def improper_energy(pos, box, impropers, k):
    """OPLS improper E = k (1 - cos 2 theta), oplspsffile.py:1125-1133."""
    if impropers.shape[0] == 0:
        return _zero(pos)
    phi = _dihedral_angle(pos, box, impropers)
    return _masked_sum(impropers[:, 0] >= 0, k * (1.0 - torch.cos(2.0 * phi)))


def bonded_energy(system, pos, box):
    """The five bonded terms as a dict (the reference's force groups,
    oplspsffile.py:169-177).  ``system`` is a tensor view on ``pos``'s
    device (``System.to``)."""
    s = system
    return {
        "bond": bond_energy(pos, box, s.bonds, s.bond_r0, s.bond_k),
        "angle": angle_energy(pos, box, s.angles, s.angle_theta0, s.angle_k),
        "urey_bradley": bond_energy(pos, box, s.ub_bonds, s.ub_r0, s.ub_k),
        "dihedral": dihedral_energy(pos, box, s.dihedrals, s.dihedral_n,
                                    s.dihedral_phase, s.dihedral_k),
        "improper": improper_energy(pos, box, s.impropers, s.improper_k),
    }
