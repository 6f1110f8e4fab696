"""The per-step physics of the middle-scheme integrator as functions on
tensors (counterpart of ``openmm_velocityverlet_tpu/integrators/
stepping.py``, the TGNH path: kinetic energy, molecular COM velocities,
``nh_scale_velocities``, the Drude hard wall, the image sync and the
compensated position update).

The JAX version embeds its static masks and mass ratios as compile-time
constants; here ``thermostat_tables`` and ``hardwall_tables`` upload them
once per context, so a step makes no host-to-device copy.  Langevin, the
E-field and cosine acceleration are not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import numpy as np
import torch

from ..units import BOLTZ
from .nhchain import propagate_nh_chains
from .vv import TG_ATOM, TG_COM, TG_DRUDE, IntegratorData


# ---------------------------------------------------- per-atom pair tables
def _pair_atom_tables(pairs, n):
    """Per-atom view of a disjoint (drude, parent) pair set: partner index,
    +1/-1 orientation sign (first/second element), lowest-id of the pair
    (for shared noise draws) and membership mask: per-pair results stay
    per-atom (a partner gather plus elementwise math under a static mask),
    with no scatter back."""
    pairs = np.asarray(pairs)
    partner = np.arange(n, dtype=np.int32)
    sign = np.zeros(n, np.float32)
    lowid = np.arange(n, dtype=np.int32)
    in_pair = np.zeros(n, bool)
    if pairs.shape[0]:
        d, p = pairs[:, 0], pairs[:, 1]
        partner[d] = p
        partner[p] = d
        sign[d] = 1.0
        sign[p] = -1.0
        lo = np.minimum(d, p)
        lowid[d] = lo
        lowid[p] = lo
        in_pair[d] = True
        in_pair[p] = True
    return partner, sign, lowid, in_pair




# ---------------------------------------------------------------- kinetics
def kinetic_energy(vel, masses):
    return 0.5 * torch.sum(masses[:, None] * vel * vel)


def mol_runs_from_id(mol_id, tail_inert=None):
    """Contiguous-molecule runs [(atom_start, n_mol, atoms_per_mol), ...].

    PSF atom order keeps every molecule contiguous and molecules sorted, so
    per-molecule reductions become plain reshapes — no (M, Mmax) member
    gather and no (N,) mol_id gather for the broadcast back.  Returns None
    when the layout doesn't hold (callers then use the dense-table
    fallback).

    ``tail_inert`` (N,) bool extends the layout to the EDL wiring, where the
    image atoms appended after the real molecules REUSE the mol ids of their
    mirrored IL molecules (run-edl image bookkeeping): when every molecule is
    complete within the sorted prefix and every atom past it is COM-inert
    (massless AND outside all NH temp groups — the caller's mask), the runs
    cover the prefix exactly: the tail contributes zero to every COM and the
    broadcast back is never read at tail rows, so mol_broadcast zero-fills
    them."""
    mid = np.asarray(mol_id)
    if mid.size == 0:
        return None
    d = np.diff(mid)
    desc = np.flatnonzero(d < 0)
    if desc.size == 0:
        n_prefix = mid.size
    else:
        # candidate prefix ends at the first descent; valid only when the
        # whole tail is COM-inert
        n_prefix = int(desc[0]) + 1
        if tail_inert is None or not bool(np.all(tail_inert[n_prefix:])):
            return None
    pre = mid[:n_prefix]
    starts = np.flatnonzero(np.r_[True, np.diff(pre) != 0])
    if not np.array_equal(pre[starts], np.arange(starts.size)):
        return None
    if desc.size and int(pre[-1]) != int(mid.max()):
        # a molecule exists only in the tail: the prefix COMs would miss it
        return None
    counts = np.diff(np.r_[starts, n_prefix])
    runs = []
    for s, c in zip(starts, counts):
        if runs and c == runs[-1][2]:
            runs[-1][1] += 1
        else:
            runs.append([int(s), 1, int(c)])
    return tuple(tuple(r) for r in runs)


def com_velocities(vel, tables):
    """Per-molecule mass-weighted COM velocity (calcCOMVelocities,
    drudeNoseHoover.cu:5-31): with contiguous-molecule runs a reshape and a
    weighted sum, otherwise a gather over the dense member table."""
    if tables["mol_runs"] is not None:
        outs = []
        for (s, m, apm), w in zip(tables["mol_runs"], tables["run_w"]):
            v = vel[s:s + m * apm].reshape(m, apm, 3)
            outs.append(torch.sum(w[:, :, None] * v, dim=1))
        return outs[0] if len(outs) == 1 else torch.cat(outs, 0)
    idx, wm = tables["mol_idx"], tables["mol_w"]
    return torch.sum(wm[..., None] * vel[idx], dim=1) \
        * tables["mol_inv_masses"][:, None]


def mol_broadcast(com, runs, n=None):
    """Per-molecule rows (M,3) back to per-atom rows for contiguous runs;
    rows past the runs' coverage (a COM-inert tail) are zero."""
    outs = []
    ms = 0
    covered = 0
    for s, m, apm in runs:
        outs.append(torch.repeat_interleave(com[ms:ms + m], apm, dim=0))
        ms += m
        covered = s + m * apm
    if n is not None and n > covered:
        outs.append(torch.zeros((n - covered, 3), dtype=com.dtype,
                                device=com.device))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 0)


# ------------------------------------------------------------- NH scaling
def thermostat_tables(system, data: IntegratorData, device):
    """Device constants of ``nh_scale_velocities`` for one system."""
    n = system.n_atoms
    masses = np.asarray(system.masses)
    inv_m = np.asarray(system.inv_masses)
    mol_id = np.asarray(system.particle_mol_id)
    t = dict(n=n, use_com=data.use_com_temp_group)

    def T(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=device)

    runs = mol_runs_from_id(mol_id, tail_inert=(masses == 0.0)
                            & ~np.asarray(data.nh_mask))
    t["mol_runs"] = runs
    if data.use_com_temp_group:
        w_all = masses * np.asarray(system.mol_inv_masses)[mol_id]
        if runs is not None:
            t["run_w"] = [T(w_all[s:s + m * apm].reshape(m, apm))
                          for s, m, apm in runs]
        else:
            table = np.asarray(system.mol_table)
            idx = np.maximum(table, 0)
            t["mol_idx"] = T(idx, np.int64)
            t["mol_w"] = T(masses[idx] * (table >= 0))
            t["mol_inv_masses"] = T(system.mol_inv_masses)
        t["mol_id"] = T(mol_id, np.int64)
        t["nh_mask"] = T(data.nh_mask, bool)
        t["nh_mol_mask"] = T(data.nh_mol_mask, bool)
        t["mol_masses"] = T(system.mol_masses)
    nn = np.asarray(data.nh_normal)
    normal = np.zeros(n, bool)
    if nn.shape[0]:
        normal[nn] = True
    normal &= inv_m > 0
    t["has_normal"] = bool(nn.shape[0])
    t["normal_mask"] = T(normal, bool)
    t["normal_w"] = T(np.where(normal, masses, 0.0))
    t["has_pairs"] = bool(data.nh_pairs.shape[0])
    if t["has_pairs"]:
        partner, psign, _, in_pair = _pair_atom_tables(data.nh_pairs, n)
        mp = masses[partner]
        mtot = np.maximum(masses + mp, 1e-30)
        pair_w = np.where(in_pair, 0.5, 0.0)
        t["partner"] = T(partner, np.int64)
        t["psign"] = T(psign)[:, None]
        t["in_pair"] = T(in_pair, bool)[:, None]
        t["fself"] = T(masses / mtot)[:, None]
        t["fpart"] = T(mp / mtot)[:, None]
        t["pair_wm"] = T(pair_w * mtot)[:, None]
        t["pair_wmu"] = T(pair_w * (masses * mp / mtot).astype(np.float32)
                          )[:, None]
    t["eta_mass"] = T(data.eta_mass)
    t["nkbt"] = T(data.temp_group_nkbt)
    t["t_target"] = T([data.temperature, data.temperature,
                       data.drude_temperature])
    return t


def nh_scale_velocities(vel, data: IntegratorData, tables, nh_eta,
                        nh_eta_dot, nh_eta_dotdot):
    """One TGNH thermostat application (scaleVelocity,
    CudaVVKernels.cpp:670-754 + drudeNoseHoover.cu), on the device.
    Returns (vel', eta', eta_dot', eta_dotdot', ke2 per group)."""
    t = tables
    zero = torch.zeros((), dtype=vel.dtype, device=vel.device)
    if t["use_com"]:
        com = com_velocities(vel, t)                       # (M,3)
        com_b = (mol_broadcast(com, t["mol_runs"], n=vel.shape[0])
                 if t["mol_runs"] is not None else com[t["mol_id"]])
        vel_rel = torch.where(t["nh_mask"][:, None], vel - com_b, vel)
    else:
        vel_rel = vel
    if t["has_pairs"]:
        vp = vel_rel[t["partner"]]
        cm_a = t["fself"] * vel_rel + t["fpart"] * vp      # pair COM vel
        rel_a = t["psign"] * (vel_rel - vp)                # v_d - v_p
    # group kinetic energies (2*KE); each pair contributes through both
    # members, so the pair weights carry a factor 1/2
    ke2_atom = (torch.sum(t["normal_w"][:, None] * vel_rel * vel_rel)
                if t["has_normal"] else zero)
    ke2_com = (torch.sum(torch.where(
        t["nh_mol_mask"], t["mol_masses"] * torch.sum(com ** 2, -1), zero))
        if t["use_com"] else zero)
    if t["has_pairs"]:
        ke2_atom = ke2_atom + torch.sum(t["pair_wm"] * cm_a * cm_a)
        ke2_drude = torch.sum(t["pair_wmu"] * rel_a * rel_a)
    else:
        ke2_drude = zero
    ke2 = torch.stack([ke2_atom, ke2_com, ke2_drude])
    eta, eta_dot, eta_dotdot, factors = propagate_nh_chains(
        nh_eta, nh_eta_dot, nh_eta_dotdot, t["eta_mass"], ke2, t["nkbt"],
        t["t_target"], data.dt, data.num_nh_chains, data.loops_per_step)
    s_atom, s_com, s_drude = (factors[TG_ATOM], factors[TG_COM],
                              factors[TG_DRUDE])
    # v_i' = s_atom*cm + sign_i * s_drude * rel * m_j/(m_i+m_j) + s_com*vcom
    com_term = s_com * com_b if t["use_com"] else zero
    new_vel = vel
    if t["has_normal"]:
        new_vel = torch.where(t["normal_mask"][:, None],
                              s_atom * vel_rel + com_term, new_vel)
    if t["has_pairs"]:
        upd = s_atom * cm_a + (s_drude * rel_a) * (t["psign"] * t["fpart"]) \
            + com_term
        new_vel = torch.where(t["in_pair"], upd, new_vel)
    return new_vel, eta, eta_dot, eta_dotdot, ke2


# ------------------------------------------------------------- hard wall
def hardwall_tables(system, data: IntegratorData, device):
    """Device constants of ``apply_hardwall``, or None when the wall is
    off."""
    if data.drude_pairs.shape[0] == 0 or data.max_drude_distance <= 0:
        return None
    n = system.n_atoms
    partner, psign, _, in_pair = _pair_atom_tables(data.drude_pairs, n)
    masses = np.asarray(system.masses)
    inv_np = np.asarray(system.inv_masses)
    m_self = masses[:, None]
    m_part = masses[partner][:, None]
    is_drude = (psign > 0)[:, None]
    m_drude = np.where(is_drude, m_self, m_part)
    parent_massless = np.where(is_drude[:, 0], inv_np[partner] == 0,
                               inv_np == 0.0)[:, None]
    mtot = np.maximum(m_self + m_part, 1e-30)

    def T(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=device)

    return dict(
        partner=T(partner, np.int64), psign=T(psign)[:, None],
        in_pair=T(in_pair, bool)[:, None], is_drude=T(is_drude, bool),
        parent_massless=T(parent_massless, bool),
        m_self=T(m_self), m_part=T(m_part), mtot=T(mtot),
        inv_sqrt_md=T(1.0 / np.sqrt(np.maximum(m_drude, 1e-30))),
        dmax=float(data.max_drude_distance),
        hw_scale=float(np.sqrt(BOLTZ * data.drude_temperature)),
        dt=float(data.dt))


def apply_hardwall(pos, vel, tables):
    """Drude hard-wall bounce (applyHardWallConstraints, middle.cu:106-221):
    a Drude-parent distance beyond maxDrudeDistance reflects the pair into
    the wall with a thermal-velocity rescale.  Per-atom pair form: every
    pair atom evaluates the shared bounce and takes its own update."""
    if tables is None:
        return pos, vel
    t = tables
    dmax, hw_scale, dt = t["dmax"], t["hw_scale"], t["dt"]
    psign, is_drude = t["psign"], t["is_drude"]
    m_self, m_part, mtot = t["m_self"], t["m_part"], t["mtot"]
    pp = pos[t["partner"]]
    vp = vel[t["partner"]]
    delta = psign * (pos - pp)             # pos_d - pos_p, both members
    r = torch.sqrt(torch.sum(delta * delta, -1, keepdim=True) + 1e-20)
    viol = (r > dmax) & t["in_pair"]
    bond_dir = delta / r
    delta_r = r - dmax
    dot_self = torch.sum(vel * bond_dir, -1, keepdim=True)
    dot_part = torch.sum(vp * bond_dir, -1, keepdim=True)
    dot1 = torch.where(is_drude, dot_self, dot_part)
    vperp = vel - bond_dir * dot_self
    dt_t = torch.full_like(dot1, dt)

    # massless-parent branch (middle.cu:137-160): parent unchanged
    dt1 = torch.where(dot1 != 0, delta_r / torch.abs(dot1 + 1e-20), dt_t)
    dt1 = torch.minimum(dt1, dt_t)
    new_dot1_a = -dot1 * hw_scale / torch.abs(dot1 + 1e-20) \
        * t["inv_sqrt_md"]
    pos_a = torch.where(is_drude, pos + bond_dir * (-delta_r
                                                    + dt1 * new_dot1_a), pos)
    vel_a = torch.where(is_drude, vperp + bond_dir * new_dot1_a, vel)

    # both-massive branch (middle.cu:161-213)
    c_self = dot_self - (m_self * dot_self + m_part * dot_part) / mtot
    vb_cm = dot_self - c_self
    c_other = dot_part - vb_cm
    dt2 = torch.where(c_self != c_other,
                      delta_r / torch.abs(c_self - c_other + 1e-20), dt_t)
    dt2 = torch.minimum(dt2, dt_t)
    v_bond = hw_scale * t["inv_sqrt_md"]
    nd_self = -c_self * v_bond * (m_part / mtot) / torch.abs(c_self + 1e-20)
    dr_self = psign * (-delta_r) * (m_part / mtot) + dt2 * nd_self
    pos_b = pos + bond_dir * dr_self
    vel_b = vperp + bond_dir * (nd_self + vb_cm)

    pm = t["parent_massless"]
    new_pos = torch.where(pm, pos_a, pos_b)
    new_vel = torch.where(pm, vel_a, vel_b)
    return torch.where(viol, new_pos, pos), torch.where(viol, new_vel, vel)


# ------------------------------------------------------------ image sync
def update_image_positions(pos, image_pairs, mirror_location):
    """Mirror image particles across the electrode plane: copy x,y; reflect
    z (updateImagePositions, imageCharge.cu:2-28).  ``image_pairs`` is a
    (I,2) int64 tensor of (image, parent)."""
    if image_pairs.shape[0] == 0:
        return pos
    pp = pos[image_pairs[:, 1]]
    new = torch.cat([pp[:, 0:2], 2.0 * mirror_location - pp[:, 2:3]], dim=1)
    return pos.index_put((image_pairs[:, 0],), new)


# --------------------------------------------------- compensated updates
def compensated_add(pos, err, delta):
    """pos_new = pos + delta with Kahan-style error carry (the reference's
    posq + posqCorrection split, middle.cu:80-97)."""
    t = delta + err
    new = pos + t
    new_err = t - (new - pos)
    return new, new_err
