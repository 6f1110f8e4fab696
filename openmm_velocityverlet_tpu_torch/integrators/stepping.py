"""The per-step physics of the VV / middle-scheme integrator as functions
on tensors (counterpart of ``openmm_velocityverlet_tpu/integrators/
stepping.py``: kinetic energy, molecular COM velocities,
``nh_scale_velocities``, the partitioned Langevin thermostat, the E-field
and cosine-acceleration extra forces with the velocity bias and viscosity,
the Drude hard wall, the image sync and the compensated position update).

The JAX version embeds its static masks and mass ratios as compile-time
constants; here ``thermostat_tables``, ``langevin_tables`` and
``hardwall_tables`` upload them once per context, so a step makes no
host-to-device copy.  The Langevin functions take their normal draws as
tensors (the JAX ones draw from a threefry key), so a test can hand both
packages the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..units import AVOGADRO, BOLTZ, PI
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


# ------------------------------------------------------------ Langevin
def langevin_tables(system, data: IntegratorData, device):
    """Device constants of the partitioned Langevin thermostat (the
    ``ld_normal`` particles and the ``ld_pairs`` Drude pairs), or None when
    no particle is on it.  The coefficients are computed in numpy exactly as
    the JAX functions compute their compile-time constants."""
    n_normal, n_pairs = data.ld_normal.shape[0], data.ld_pairs.shape[0]
    if n_normal + n_pairs == 0:
        return None
    n = system.n_atoms
    dt = data.dt
    masses_np = np.asarray(system.masses)

    def T(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=device)

    t = dict(n=n, n_normal=n_normal, n_pairs=n_pairs)
    # langevin_extra_force: dragFactor gamma, randFactor sqrt(2 kB T gamma
    # / dt), as float32 scalars
    t["drag"], t["drag_d"] = data.friction, data.drude_friction
    t["rand"] = float(np.sqrt(np.float32(
        2.0 * BOLTZ * data.temperature * data.friction / dt)))
    t["rand_d"] = float(np.sqrt(np.float32(
        2.0 * BOLTZ * data.drude_temperature * data.drude_friction / dt)))
    if n_normal:
        norm_mask = np.zeros(n, bool)
        norm_mask[np.asarray(data.ld_normal)] = True
        c1 = float(np.exp(-data.friction * dt))
        sig = np.where(masses_np > 0,
                       np.sqrt(BOLTZ * data.temperature
                               / np.maximum(masses_np, 1e-30)
                               * (1.0 - c1 * c1)), 0.0).astype(np.float32)
        idx = np.asarray(data.ld_normal)
        m = masses_np[idx][:, None]
        t.update(norm_mask=T(norm_mask, bool)[:, None], c1=c1,
                 sig=T(sig)[:, None], idx=T(idx, np.int64), m=T(m),
                 sqrt_m=T(np.sqrt(m)))
    if n_pairs:
        partner, psign, lowid, in_pair = _pair_atom_tables(data.ld_pairs, n)
        mp = masses_np[partner]
        mtot = np.maximum(masses_np + mp, 1e-30)
        mu = np.maximum(masses_np * mp / mtot, 1e-30)
        c1c = float(np.exp(-data.friction * dt))
        c1r = float(np.exp(-data.drude_friction * dt))
        d, p = data.ld_pairs[:, 0], data.ld_pairs[:, 1]
        m1, m2 = masses_np[d], masses_np[p]
        pm_tot = (m1 + m2)[:, None]
        pmu = (m1 * m2 / (m1 + m2))[:, None]
        t.update(
            partner=T(partner, np.int64), psign=T(psign)[:, None],
            lowid=T(lowid, np.int64), in_pair=T(in_pair, bool)[:, None],
            fself=T(masses_np / mtot)[:, None], fpart=T(mp / mtot)[:, None],
            c1c=c1c, c1r=c1r,
            sig_cm=T(np.sqrt(BOLTZ * data.temperature / mtot
                             * (1.0 - c1c * c1c)))[:, None],
            sig_rel=T(np.sqrt(BOLTZ * data.drude_temperature / mu
                              * (1.0 - c1r * c1r)))[:, None],
            d=T(d, np.int64), p=T(p, np.int64), pm_tot=T(pm_tot),
            pmu=T(pmu), f1=T(m1[:, None] / pm_tot), f2=T(m2[:, None] / pm_tot),
            sqrt_mtot=T(np.sqrt(pm_tot)), sqrt_mu=T(np.sqrt(pmu)))
    return t


def langevin_ou_update(vel, tables, xi_n, xi_p):
    """Exact Ornstein-Uhlenbeck velocity update of the Langevin particles
    (the middle-scheme form of the JAX ``langevin_ou_update``):
    v <- c1 v + sqrt(kT/m (1 - c1^2)) xi with c1 = exp(-gamma dt), applied
    to normal particles at T, to each Drude pair's centre of mass at T and
    to its relative motion at T_drude.

    The normal draws come in as tensors, in the JAX shapes and draw order:
    ``xi_n`` (n, 3) for the normal particles (draws of other atoms are
    discarded by the mask) and ``xi_p`` (n, 2, 3) for the pairs, read at
    each pair's lower index so both members share one draw."""
    t = tables
    if t["n_normal"]:
        vel = torch.where(t["norm_mask"], t["c1"] * vel + t["sig"] * xi_n,
                          vel)
    if t["n_pairs"]:
        psign, fpart = t["psign"], t["fpart"]
        vp = vel[t["partner"]]
        cm = t["fself"] * vel + fpart * vp
        rel = psign * (vel - vp)
        xi = xi_p[t["lowid"]]
        cm = t["c1c"] * cm + t["sig_cm"] * xi[:, 0]
        rel = t["c1r"] * rel + t["sig_rel"] * xi[:, 1]
        vel = torch.where(t["in_pair"], cm + psign * fpart * rel, vel)
    return vel


def langevin_extra_force(vel, tables, xi_n, xi_p):
    """Partitioned Langevin drag and noise as an extra force
    (addExtraForceDrudeLangevin, drudeLangevin.cu:2-60; the vanilla VV
    scheme's form).  Draws as in the JAX function: ``xi_n`` (Ln, 3) for the
    normal particles, ``xi_p`` (Lp, 2, 3) for the pairs' centre-of-mass and
    relative motion."""
    t = tables
    f = torch.zeros_like(vel)
    drag, rand = t["drag"], t["rand"]
    if t["n_normal"]:
        idx, m = t["idx"], t["m"]
        f = f.index_add(0, idx, -drag * m * vel[idx] + rand * t["sqrt_m"]
                        * xi_n)
    if t["n_pairs"]:
        d, p, f1, f2 = t["d"], t["p"], t["f1"], t["f2"]
        cm = vel[d] * f1 + vel[p] * f2
        rel = vel[p] - vel[d]
        cm_f = -drag * t["pm_tot"] * cm + rand * t["sqrt_mtot"] * xi_p[:, 0]
        rel_f = -t["drag_d"] * t["pmu"] * rel \
            + t["rand_d"] * t["sqrt_mu"] * xi_p[:, 1]
        f = f.index_add(0, d, f1 * cm_f - rel_f)
        f = f.index_add(0, p, f2 * cm_f + rel_f)
    return f


# --------------------------------------------------------- extra "forces"
def efield_extra_force(charges, data: IntegratorData):
    """q E on the electrolyte particles along z (electricField.cu:2-12), a
    host numpy (N,) constant; efscale = field * AVOGADRO converts
    kJ/(nm e) -> kJ/(mol nm e) (CudaVVKernels.cpp:978)."""
    efscale = data.electric_field * AVOGADRO
    n = charges.shape[0]
    mask = np.zeros(n, np.float32)
    mask[np.asarray(data.electrolyte)] = 1.0
    return efscale * np.asarray(charges) * mask


def image_site_tables(system, image_pairs, device):
    """(rows, parents (V, 3), weights (V, 3)) on ``device`` of the virtual
    sites that are the parents of image pairs ((image, parent) rows), or
    None where no image's parent is one: the image sync mirrors such a
    site's placement, a weighted average of its parents.  A site with a
    local-frame offset is refused."""
    vi = np.asarray(system.vsite_index).reshape(-1)
    pairs = np.asarray(image_pairs).reshape(-1, 2)
    sel = np.isin(vi, pairs[:, 1]) if pairs.shape[0] else np.zeros(0, bool)
    if not sel.any():
        return None
    if np.any(np.asarray(system.vsite_local)[sel] != 0):
        raise ValueError("an image of a virtual site with a local-frame "
                         "offset is not supported")
    return (torch.as_tensor(vi[sel].astype(np.int64), device=device),
            torch.as_tensor(np.asarray(system.vsite_parents)[sel].astype(
                np.int64), device=device),
            torch.as_tensor(np.asarray(system.vsite_origin_w,
                                       np.float32)[sel], device=device))


def vsite_field_to_parents(field, system):
    """The per-row field force ``field`` (N,) with each virtual site's share
    moved onto its parents by the site's weights.  A site has no mass, so a
    force left on its row would move nothing, and a neutral molecule with a
    charged site would feel a net force along the field.  Exact for sites
    placed as weighted averages of their parents; a charged field row on a
    site with a local-frame offset is refused (its share would turn with
    the frame)."""
    vi = np.asarray(system.vsite_index).reshape(-1)
    carry = field[vi] != 0 if vi.size else np.zeros(0, bool)
    if not carry.any():
        return field
    if np.any(np.asarray(system.vsite_local)[carry] != 0):
        raise ValueError("the E-field on a virtual site with a local-frame "
                         "offset is not supported: list its parents instead")
    out = np.asarray(field, np.float64).copy()
    w = np.asarray(system.vsite_origin_w, np.float64)[carry]
    np.add.at(out, np.asarray(system.vsite_parents)[carry],
              w * out[vi[carry], None])
    out[vi[carry]] = 0.0
    return out.astype(np.asarray(field).dtype)


def _cos_z(pos, box):
    return torch.cos(2.0 * PI * pos[:, 2] / box[2])


def cos_extra_force(pos, masses, box, acceleration):
    """F_x = m a cos(2 pi z / Lz) (cosineAccelerate.cu:2-14)."""
    return masses * acceleration * _cos_z(pos, box)


def cos_velocity_bias(pos, vel, masses, box):
    """V = sum_i m_i v_xi 2 cos(2 pi z_i/Lz) / M_total, a device scalar
    (calcPeriodicVelocityBias + sumV, cosineAccelerate.cu:16-61)."""
    return torch.sum(masses * vel[:, 0] * 2.0 * _cos_z(pos, box)) \
        / torch.sum(masses)


def cos_shift_velocity(pos, vel, box, v_amp, sign):
    """v_x -> v_x + sign V cos(2 pi z/Lz) (remove: sign=-1, restore: +1)."""
    vx = vel[:, 0] + sign * v_amp * _cos_z(pos, box)
    return torch.stack([vx, vel[:, 1], vel[:, 2]], dim=1)


def inverse_viscosity(v_amp, box, masses, acceleration):
    """1/eta = V vol/(M_total a) (2 pi/Lz)^2 in MD units
    (calcViscosity, CudaVVKernels.cpp:1112-1134); times 6.02214076e5 it is
    in 1/(Pa s) (velocityverletplugin.i:75-79)."""
    vol = box[0] * box[1] * box[2]
    inv_mass_total = 1.0 / torch.sum(masses)
    return (v_amp * vol * inv_mass_total / acceleration
            * (2.0 * PI / box[2]) ** 2)


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
    with trace.span("step.hardwall"):
        return _hardwall(pos, vel, tables)


def _hardwall(pos, vel, t):
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
def update_image_positions(pos, image_pairs, mirror_location,
                           parent_pos=None):
    """Mirror image particles across the electrode plane: copy x,y; reflect
    z (updateImagePositions, imageCharge.cu:2-28).  ``image_pairs`` is a
    (I,2) int64 tensor of (image, parent); the parents' rows are read from
    ``parent_pos`` where given (positions with virtual sites placed), else
    from ``pos``."""
    if image_pairs.shape[0] == 0:
        return pos
    pp = (pos if parent_pos is None else parent_pos)[image_pairs[:, 1]]
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
