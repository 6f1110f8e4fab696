"""Small nonbonded terms (counterpart of
``openmm_velocityverlet_tpu/ops/nonbonded.py``): the Ewald self and
background energy, the LJ long-range dispersion correction and the CLPol
Tang-Toennies damping energy and the NBTHOLE screened dipole-dipole energy
(forces of the last two by autograd)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..units import ONE_4PI_EPS0, PI
from ..utils.pbc import minimum_image

_SQRT_PI = 1.7724538509055159
# the most pairs of one row block of the NBTHOLE sweep (64 MiB of float32)
NBTHOLE_BLOCK_ELEMS = 1 << 24


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


class NbtholeTables(NamedTuple):
    """The NBTHOLE sweep's static tables on one device: the active atoms
    (nbt_idx > 0), their charges, the (Na, Na) screening matrix
    s_ij = coef(t_i, t_j) alpha_i alpha_j 10 [1/nm] and the pairs that
    interact (different types, nonzero coefficient, not excluded, not the
    diagonal)."""
    active: torch.Tensor     # (Na,) int64
    q: torch.Tensor          # (Na,) f32
    screen: torch.Tensor     # (Na, Na) f32
    pair_ok: torch.Tensor    # (Na, Na) bool


def nbthole_tables(nbt_idx, nbt_alpha, nbt_coef, charges, exclusions,
                   device) -> NbtholeTables | None:
    """The tables the JAX ``nbthole_energy`` builds on the host at every
    trace, built once; None when no atom carries an NBTHOLE type."""
    nbt_idx = np.asarray(nbt_idx)
    active = np.where(nbt_idx > 0)[0]
    if active.size == 0:
        return None
    t = nbt_idx[active]
    alpha = np.asarray(nbt_alpha)[active]
    coef = np.asarray(nbt_coef, np.float64)
    screen = (coef[t[:, None], t[None, :]]
              * alpha[:, None] * alpha[None, :] * 10.0).astype(np.float32)
    pair_ok = (screen != 0.0) & (t[:, None] != t[None, :])
    exl = np.asarray(exclusions).reshape(nbt_idx.shape[0], -1)
    pos_in_active = -np.ones(exl.shape[0], np.int64)
    pos_in_active[active] = np.arange(active.size)
    cols = exl[active]
    col_a = np.where(cols >= 0, pos_in_active[np.maximum(cols, 0)], -1)
    rows = np.broadcast_to(np.arange(active.size)[:, None], cols.shape)
    hit = col_a >= 0
    pair_ok[rows[hit], col_a[hit]] = False
    np.fill_diagonal(pair_ok, False)
    return NbtholeTables(
        active=torch.as_tensor(active, device=device),
        q=torch.as_tensor(np.asarray(charges, np.float32)[active],
                          device=device),
        screen=torch.as_tensor(screen, device=device),
        pair_ok=torch.as_tensor(pair_ok, device=device))


def nbthole_energy(pos, box, tables: NbtholeTables, r_cutoff):
    """NBTHOLE screened dipole-dipole energy (reference
    oplspsffile.py:1350-1405):

        E = -C q1 q2 (1 + s r / 2) exp(-s r) / r

    over the tables' interacting pairs within ``r_cutoff`` (plain periodic
    cutoff), the dense (Na, Na) sum of the JAX package halved, cut into row
    blocks of at most NBTHOLE_BLOCK_ELEMS pairs (each under ``checkpoint``)
    where Na^2 would not fit."""
    if tables is None:
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    p = pos[tables.active]
    na = p.shape[0]
    rc2 = r_cutoff * r_cutoff

    def block(p_i, q_i, screen, ok):
        dr = minimum_image(p_i[:, None, :] - p[None, :, :], box)
        r2 = torch.clamp(torch.sum(dr * dr, -1), min=1e-12)
        r = torch.sqrt(r2)
        sr = screen * r
        e = (-ONE_4PI_EPS0 * q_i[:, None] * tables.q[None, :]
             * (1.0 + 0.5 * sr) * torch.exp(-sr) / r)
        return torch.sum(torch.where(ok & (r2 < rc2), e,
                                     torch.zeros_like(e)))

    rows = max(1, NBTHOLE_BLOCK_ELEMS // max(na, 1))
    if rows >= na:
        total = block(p, tables.q, tables.screen, tables.pair_ok)
    else:
        total = sum(checkpoint(block, p[lo:lo + rows],
                               tables.q[lo:lo + rows],
                               tables.screen[lo:lo + rows],
                               tables.pair_ok[lo:lo + rows],
                               use_reentrant=False)
                    for lo in range(0, na, rows))
    return 0.5 * total
