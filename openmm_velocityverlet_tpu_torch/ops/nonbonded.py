"""Small nonbonded terms (counterpart of
``openmm_velocityverlet_tpu/ops/nonbonded.py``): the Ewald self and
background energy, the LJ long-range dispersion correction and the CLPol
Tang-Toennies damping energy (forces of the last by autograd).  NBTHOLE is
not ported yet (ROADMAP A13)."""
from __future__ import annotations

import numpy as np
import torch

from ..units import ONE_4PI_EPS0, PI
from ..utils.pbc import minimum_image

_SQRT_PI = 1.7724538509055159


def ewald_self_energy(charges, beta, box):
    """Point self-energy and neutralizing-background terms of the Ewald sum."""
    sum_q2 = torch.sum(charges * charges)
    sum_q = torch.sum(charges)
    vol = box[0] * box[1] * box[2]
    e_self = -ONE_4PI_EPS0 * beta / _SQRT_PI * sum_q2
    e_background = -ONE_4PI_EPS0 * PI / (2.0 * beta * beta * vol) \
        * sum_q * sum_q
    return e_self + e_background


def dispersion_correction(box, coef_a2, coef_b, r_cutoff, r_switch=0.0):
    """LJ long-range correction E = 2 pi/V (A2 I12 - B I6), with the energy
    removed by the switch on [rs, rc] added back by quadrature."""
    vol = box[0] * box[1] * box[2]
    rc3 = r_cutoff ** 3
    rc9 = rc3 ** 3
    i12 = 1.0 / (9.0 * rc9)
    i6 = 1.0 / (3.0 * rc3)
    if r_switch:
        r = np.linspace(float(r_switch), float(r_cutoff), 2049)
        x = (r - float(r_switch)) / (float(r_cutoff) - float(r_switch))
        one_m_s = x ** 3 * (10.0 - 15.0 * x + 6.0 * x * x)
        i12 = i12 + float(np.trapezoid(one_m_s * r ** -10, r))
        i6 = i6 + float(np.trapezoid(one_m_s * r ** -4, r))
    return 2.0 * PI / vol * (float(coef_a2) * i12 - float(coef_b) * i6)


def tt_damping_energy(pos, box, donors, tt_charges, dipole_mask, exclusions,
                      b, r_cutoff):
    """CLPol Tang-Toennies Coulomb damping between donor particles and all
    dipole sites (force.py:230-282), dense donors x atoms; tensors on the
    device of ``pos`` (index tables int64)."""
    if donors.shape[0] == 0:
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    dpos = pos[donors]
    dr = minimum_image(dpos[:, None, :] - pos[None, :, :], box)
    r2 = torch.clamp(torch.sum(dr * dr, -1), min=1e-10)
    r = torch.sqrt(r2)
    excl_d = exclusions[donors]
    tgt = torch.arange(pos.shape[0], device=pos.device)[None, :]
    is_excl = torch.any(excl_d[:, :, None] == tgt[:, None, :], dim=1)
    valid = (dipole_mask[None, :] & (r2 < r_cutoff * r_cutoff)
             & ~is_excl & (donors[:, None] != tgt))
    qq = tt_charges[donors][:, None] * tt_charges[None, :]
    br = b * r
    gamma = 1.0 + br * (1.0 + br * (0.5 + br * (1.0 / 6.0 + br / 24.0)))
    e = -ONE_4PI_EPS0 * qq / r * torch.exp(-br) * gamma
    return torch.sum(torch.where(valid, e, torch.zeros_like(e)))
