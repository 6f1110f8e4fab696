"""Closed-form Drude energies: the anisotropic spring and the Thole
screened dipole pairs (counterpart of
``openmm_velocityverlet_tpu/ops/drude.py``; the DrudeForce of the
reference builder, oplspsffile.py:1478-1517).

* spring: E = 0.5 [k3 |d|^2 + k1 (d.u12)^2 + k2 (d.u34)^2], d the
  Drude-parent displacement, u12 / u34 unit vectors between the
  anisotropy partners (isotropic rows: k1 = k2 = 0);
* Thole pair of dipoles (d1, p1) and (d2, p2): the four site-pair Coulomb
  terms with signs (+, -, -, +) each damped by 1 - (1 + u/2) exp(-u),
  u = screen r.

Energies only, differentiable in ``pos``; the step's forces come from
``term_forces``, whose forms these are the oracle of.
"""
from __future__ import annotations

import torch

from ..units import ONE_4PI_EPS0
from ..utils.pbc import minimum_image

_EPS = 1e-12


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True) + _EPS)


def drude_spring_energy(pos, box, pairs, k3, k1, k2, aniso):
    if pairs.shape[0] == 0:
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    zero = torch.zeros(pairs.shape[0], dtype=pos.dtype, device=pos.device)
    d = minimum_image(pos[pairs[:, 0].clamp(min=0)]
                      - pos[pairs[:, 1].clamp(min=0)], box)
    e = 0.5 * k3 * torch.sum(d * d, -1)
    has_aniso = aniso[:, 0] >= 0
    p = aniso.clamp(min=0)
    on = has_aniso.to(pos.dtype)[:, None]
    u12 = _unit(minimum_image(pos[p[:, 1]] - pos[p[:, 0]], box) * on)
    u34 = _unit(minimum_image(pos[p[:, 3]] - pos[p[:, 2]], box) * on)
    e = e + torch.where(has_aniso,
                        0.5 * (k1 * torch.sum(d * u12, -1) ** 2
                               + k2 * torch.sum(d * u34, -1) ** 2), zero)
    return torch.sum(torch.where(pairs[:, 0] >= 0, e, zero))


def thole_energy(pos, box, sites, qq, screen):
    """``sites`` (TP, 4) = (drude1, parent1, drude2, parent2)."""
    if sites.shape[0] == 0:
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    s = sites.clamp(min=0)
    # the four site pairs and the signs of their charge products
    ii = torch.stack([s[:, 0], s[:, 0], s[:, 1], s[:, 1]], 1)
    jj = torch.stack([s[:, 2], s[:, 3], s[:, 2], s[:, 3]], 1)
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=pos.dtype,
                        device=pos.device)
    dr = minimum_image(pos[ii] - pos[jj], box)
    r = torch.sqrt(torch.sum(dr * dr, -1) + _EPS)
    u = screen[:, None] * r
    damp = 1.0 - (1.0 + 0.5 * u) * torch.exp(-u)
    e = ONE_4PI_EPS0 * (qq[:, None] * sign) * damp / r
    return torch.sum(torch.where((sites[:, 0] >= 0)[:, None], e,
                                 torch.zeros_like(e)))
