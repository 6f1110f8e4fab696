"""Bonded, Drude, Thole and 1-4 exception terms with hand-derived analytic
forces (counterpart of ``openmm_velocityverlet_tpu/ops/term_forces.py``).

Each ``_*_ef`` returns (energy, grads) with grads[slot] = (gx, gy, gz), the
component tensors of dE/d(point of that slot); the geometry comes in through
a ``delta(a, b)`` closure so the same formulas serve this sparse gather
path ((NT,) components) and the molecule-batched path in ``mol_terms``
((m, nt) components).  ``build_term_tables`` is the host-numpy table
builder of the JAX module, unchanged; ``energies_and_forces`` accumulates the
per-atom forces through the same gather-only incidence tables.
Reference: oplspsffile.py:1000-1133, 1478-1517.
"""
from __future__ import annotations

import numpy as np
import torch

from ..units import ONE_4PI_EPS0

_EPS = 1e-12


def _mi(d, L):
    """Minimum image of one component tensor."""
    return d - L * torch.round(d / L)


def _delta(pts, a, b, box):
    """Component minimum-image displacement pts[:,a] - pts[:,b] as 3 (NT,)."""
    d = pts[:, a, :] - pts[:, b, :]
    return (_mi(d[:, 0], box[0]), _mi(d[:, 1], box[1]), _mi(d[:, 2], box[2]))


# --------------------------------------------------------------- term math
def _bond_ef(delta, prm, _unused=None):
    r0, k = prm[:, 0], prm[:, 1]
    dx, dy, dz = delta(0, 1)
    r2 = dx * dx + dy * dy + dz * dz + _EPS
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    diff = r - r0
    e = 0.5 * k * diff * diff
    c = k * diff * inv_r
    g0 = (c * dx, c * dy, c * dz)
    g1 = (-g0[0], -g0[1], -g0[2])
    return e, [g0, g1]


def _angle_ef(delta, prm, _unused=None):
    th0, k = prm[:, 0], prm[:, 1]
    ax, ay, az = delta(0, 1)   # v1 = p0 - p1
    bx, by, bz = delta(2, 1)   # v2 = p2 - p1
    r1s = ax * ax + ay * ay + az * az + _EPS
    r2s = bx * bx + by * by + bz * bz + _EPS
    inv1 = torch.rsqrt(r1s)
    inv2 = torch.rsqrt(r2s)
    dot = ax * bx + ay * by + az * bz
    cos_t = torch.clamp(dot * inv1 * inv2, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    e = 0.5 * k * (theta - th0) ** 2
    # dE/dcos = -k(theta-th0)/sin(theta)
    c = -k * (theta - th0) * torch.rsqrt(1.0 - cos_t * cos_t)
    c1 = c * inv1 * inv2
    ca = c * cos_t * inv1 * inv1
    cb = c * cos_t * inv2 * inv2
    g0 = (c1 * bx - ca * ax, c1 * by - ca * ay, c1 * bz - ca * az)
    g2 = (c1 * ax - cb * bx, c1 * ay - cb * by, c1 * az - cb * bz)
    g1 = (-(g0[0] + g2[0]), -(g0[1] + g2[1]), -(g0[2] + g2[2]))
    return e, [g0, g1, g2]


def _dihedral_ef(delta, prm, _unused=None):
    """E = k (1 + cos(n phi - phase)); improper folds in as (n=2, phase=pi).

    Gradients via the standard rigid-rotor decomposition
    (dphi/dp0 = -|b2|/|m|^2 m, dphi/dp3 = |b2|/|n|^2 n, middle atoms by
    lever rule) — equivalent to autodiff of ops/bonded.py:_dihedral_phi.
    """
    nmul, phase, k = prm[:, 0], prm[:, 1], prm[:, 2]
    b1x, b1y, b1z = delta(1, 0)
    b2x, b2y, b2z = delta(2, 1)
    b3x, b3y, b3z = delta(3, 2)
    # m = b1 x b2 ; n = b2 x b3
    mx = b1y * b2z - b1z * b2y
    my = b1z * b2x - b1x * b2z
    mz = b1x * b2y - b1y * b2x
    nx = b2y * b3z - b2z * b3y
    ny = b2z * b3x - b2x * b3z
    nz = b2x * b3y - b2y * b3x
    b2s = b2x * b2x + b2y * b2y + b2z * b2z + _EPS
    inv_b2 = torch.rsqrt(b2s)
    b2n = b2s * inv_b2
    # phi = atan2((m x b2hat).n, m.n)
    cxx = my * b2z - mz * b2y
    cxy = mz * b2x - mx * b2z
    cxz = mx * b2y - my * b2x
    yv = (cxx * nx + cxy * ny + cxz * nz) * inv_b2
    xv = mx * nx + my * ny + mz * nz
    phi = torch.atan2(yv, xv + _EPS * (xv == 0))
    arg = nmul * phi - phase
    e = k * (1.0 + torch.cos(arg))
    dedphi = -k * nmul * torch.sin(arg)
    m2 = mx * mx + my * my + mz * mz + _EPS
    n2 = nx * nx + ny * ny + nz * nz + _EPS
    ca = dedphi * b2n / m2           # dE/dp0 = ca * m
    cd = -dedphi * b2n / n2          # dE/dp3 = cd * n
    s = (b1x * b2x + b1y * b2y + b1z * b2z) / b2s
    t = (b3x * b2x + b3y * b2y + b3z * b2z) / b2s
    g0 = (ca * mx, ca * my, ca * mz)
    g3 = (cd * nx, cd * ny, cd * nz)
    g1 = (t * g3[0] - (1.0 + s) * g0[0],
          t * g3[1] - (1.0 + s) * g0[1],
          t * g3[2] - (1.0 + s) * g0[2])
    g2 = (s * g0[0] - (1.0 + t) * g3[0],
          s * g0[1] - (1.0 + t) * g3[1],
          s * g0[2] - (1.0 + t) * g3[2])
    return e, [g0, g1, g2, g3]


def _drude_ef(delta, prm, _unused=None):
    """Drude spring with optional anisotropy (DrudeForce semantics,
    oplspsffile.py:1478-1504).  idx = (drude, parent, p2, p3, p4);
    prm = (k3, k1, k2, has_aniso).  Padded aniso parents coincide with the
    parent atom; the (1-has) x-axis shift keeps normalizations finite."""
    k3, k1, k2, has = prm[:, 0], prm[:, 1], prm[:, 2], prm[:, 3]
    dx, dy, dz = delta(0, 1)
    e = 0.5 * k3 * (dx * dx + dy * dy + dz * dz)
    gdx, gdy, gdz = k3 * dx, k3 * dy, k3 * dz   # dE/d disp
    shift = 1.0 - has

    def axis(a, b, kk):
        wx, wy, wz = delta(a, b)
        wx = wx + shift
        w2 = wx * wx + wy * wy + wz * wz + _EPS
        invw = torch.rsqrt(w2)
        ux, uy, uz = wx * invw, wy * invw, wz * invw
        d1 = dx * ux + dy * uy + dz * uz
        e_a = has * (0.5 * kk * d1 * d1)
        cdisp = has * kk * d1
        # dE/dw = kk*d1*(disp - d1*u)/|w|
        cw = cdisp * invw
        gwx = cw * (dx - d1 * ux)
        gwy = cw * (dy - d1 * uy)
        gwz = cw * (dz - d1 * uz)
        return e_a, (cdisp * ux, cdisp * uy, cdisp * uz), (gwx, gwy, gwz)

    e1, gd1, gw1 = axis(2, 1, k1)
    e2, gd2, gw2 = axis(4, 3, k2)
    e = e + e1 + e2
    gdx = gdx + gd1[0] + gd2[0]
    gdy = gdy + gd1[1] + gd2[1]
    gdz = gdz + gd1[2] + gd2[2]
    zero = torch.zeros_like(dx)
    g0 = (gdx, gdy, gdz)
    # w1 = pts2 - pts1, so dE/dpts2 = gw1, dE/dpts1 -= gw1 (on top of -disp)
    g1 = (-gdx - gw1[0], -gdy - gw1[1], -gdz - gw1[2])
    g2 = gw1
    g3 = (-gw2[0], -gw2[1], -gw2[2])
    g4 = gw2
    _ = zero
    return e, [g0, g1, g2, g3, g4]


def _thole_ef(delta, prm, _unused=None):
    """Thole screened dipole-dipole: 4 site pairs between (d1,p1) and
    (d2,p2); prm = (qq, screen).  E = C qq/r (1 - (1+u/2) e^-u), u = a r."""
    qq, screen = prm[:, 0], prm[:, 1]
    grads = [[torch.zeros_like(qq) for _ in range(3)] for _ in range(4)]
    e = torch.zeros_like(qq)

    for a, b, sign in ((0, 2, 1.0), (0, 3, -1.0), (1, 2, -1.0), (1, 3, 1.0)):
        dx, dy, dz = delta(a, b)
        r2 = dx * dx + dy * dy + dz * dz + _EPS
        inv_r = torch.rsqrt(r2)
        u = screen * r2 * inv_r
        ex = torch.exp(-u)
        s = 1.0 - (1.0 + 0.5 * u) * ex
        sp = 0.5 * (1.0 + u) * ex
        pref = ONE_4PI_EPS0 * sign * qq
        e = e + pref * s * inv_r
        # dE/dr = pref*(sp*screen/r - s/r^2); coef = dE/dr / r
        coef = pref * (sp * screen - s * inv_r) * inv_r * inv_r
        grads[a][0] = grads[a][0] + coef * dx
        grads[a][1] = grads[a][1] + coef * dy
        grads[a][2] = grads[a][2] + coef * dz
        grads[b][0] = grads[b][0] - coef * dx
        grads[b][1] = grads[b][1] - coef * dy
        grads[b][2] = grads[b][2] - coef * dz
    return e, [tuple(g) for g in grads]


def _exception_ef(delta, prm, _unused=None):
    """1-4 exception: full scaled Coulomb + LJ in one pass.
    prm: (qq, c6, c12); returns ((coul, lj) energy split, grads)."""
    qq, c6, c12 = prm[:, 0], prm[:, 1], prm[:, 2]
    dx, dy, dz = delta(0, 1)
    r2 = dx * dx + dy * dy + dz * dz + _EPS
    inv_r2 = 1.0 / r2
    inv_r = torch.rsqrt(r2)
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    e_coul = qq * inv_r
    e12 = c12 * inv_r6 * inv_r6
    e6 = c6 * inv_r6
    e_lj = e12 - e6
    # coef = (dE/dr)/r
    coef = (-e_coul - 12.0 * e12 + 6.0 * e6) * inv_r2
    g0 = (coef * dx, coef * dy, coef * dz)
    g1 = (-g0[0], -g0[1], -g0[2])
    return (e_coul, e_lj), [g0, g1]


_TERM_FNS = {
    "exception": (_exception_ef, 2),
    "bond": (_bond_ef, 2),
    "angle": (_angle_ef, 3),
    "dihedral": (_dihedral_ef, 4),
    "drude": (_drude_ef, 5),
    "thole": (_thole_ef, 4),
}


def build_term_tables(system, exc_keep_mask=None, keep_masks=None):
    """Host-side: per-term index/param arrays + the combined incidence table.

    Returns (terms, incidence, total_slots) where terms is a list of
    (name, idx (NT,P) i32, prm (NT,Q) f32, split) and incidence indexes the
    term-major flat contribution array (entry = base + term*P + slot),
    matching the runtime's (NT,P,3).reshape(-1,3) per-term stacks.

    ``keep_masks``: optional dict kind -> bool mask over the kind's merged table
    (bond+urey_bradley, dihedral+improper) selecting the terms this sparse
    path should still evaluate; kinds absent from the dict keep everything.
    Used by ops/mol_terms.py to route only its uncovered leftovers here.
    """
    s = system
    terms = []

    def _keep(kind, *arrays):
        if keep_masks is None or kind not in keep_masks:
            return arrays
        m = np.asarray(keep_masks[kind], bool)
        return tuple(a[m] for a in arrays)
    # Merged term groups keep the number of fused passes per step low:
    # Urey-Bradley bonds are bonds, and the OPLS improper k(1-cos 2 phi)
    # equals a dihedral with n=2, phase=pi.  ``split``: (labels, which) to
    # recover per-group energy reports.
    nb, nu = s.bonds.shape[0], s.ub_bonds.shape[0]
    if nb + nu:
        idx = np.concatenate([np.asarray(s.bonds, np.int32).reshape(-1, 2),
                              np.asarray(s.ub_bonds,
                                         np.int32).reshape(-1, 2)], 0)
        prm = np.concatenate(
            [np.stack([s.bond_r0, s.bond_k], -1).reshape(-1, 2),
             np.stack([s.ub_r0, s.ub_k], -1).reshape(-1, 2)],
            0).astype(np.float32)
        which = np.concatenate([np.zeros(nb), np.ones(nu)]).astype(np.float32)
        idx, prm, which = _keep("bond", idx, prm, which)
        if idx.shape[0]:
            terms.append(("bond", idx, prm,
                          (("bond", "urey_bradley"), which)))
    if s.angles.shape[0]:
        a_idx, a_prm = _keep("angle", np.asarray(s.angles, np.int32),
                             np.stack([s.angle_theta0, s.angle_k],
                                      -1).astype(np.float32))
        if a_idx.shape[0]:
            terms.append(("angle", a_idx, a_prm, None))
    nd, ni = s.dihedrals.shape[0], s.impropers.shape[0]
    if nd + ni:
        idx = np.concatenate([np.asarray(s.dihedrals,
                                         np.int32).reshape(-1, 4),
                              np.asarray(s.impropers,
                                         np.int32).reshape(-1, 4)], 0)
        imp_k = np.asarray(s.improper_k, np.float32).reshape(-1)
        prm = np.concatenate(
            [np.stack([s.dihedral_n, s.dihedral_phase,
                       s.dihedral_k], -1).reshape(-1, 3),
             np.stack([np.full(ni, 2.0), np.full(ni, np.pi), imp_k],
                      -1).reshape(-1, 3)], 0).astype(np.float32)
        which = np.concatenate([np.zeros(nd), np.ones(ni)]).astype(np.float32)
        idx, prm, which = _keep("dihedral", idx, prm, which)
        if idx.shape[0]:
            terms.append(("dihedral", idx, prm,
                          (("dihedral", "improper"), which)))
    if s.drude_pairs.shape[0]:
        dp = np.asarray(s.drude_pairs, np.int32)
        da = np.asarray(s.drude_aniso, np.int32)
        has = (da[:, 0] >= 0).astype(np.float32)
        # pad aniso atom slots with the parent so gathers stay in range
        da_safe = np.where(da >= 0, da, dp[:, 1:2])
        idx = np.concatenate([dp, da_safe[:, 1:2], da_safe[:, 2:3],
                              da_safe[:, 3:4]], axis=1)  # (D,5): d,p,p2,p3,p4
        prm = np.stack([s.drude_k3, s.drude_k1, s.drude_k2, has],
                       -1).astype(np.float32)
        idx, prm = _keep("drude", idx, prm)
        if idx.shape[0]:
            terms.append(("drude", idx, prm, None))
    exc_idx = np.asarray(s.exc_idx)
    if exc_idx.size and (exc_idx >= 0).any():
        n_atoms, xa = exc_idx.shape
        ii = np.repeat(np.arange(n_atoms), xa)
        jj = exc_idx.reshape(-1)
        keep = (jj >= 0) & (jj > ii)          # each exception once
        if exc_keep_mask is not None:
            # exceptions the pair kernel already handles (or that are pure
            # exclusions) are dropped from the sparse pass
            keep &= np.asarray(exc_keep_mask).reshape(-1)
        pe = np.stack([ii[keep], jj[keep]], -1).astype(np.int32)
        if pe.shape[0]:
            qq = np.asarray(s.exc_qq).reshape(-1)[keep].astype(np.float32)
            c6 = np.asarray(s.exc_c6).reshape(-1)[keep].astype(np.float32)
            c12 = np.asarray(s.exc_c12).reshape(-1)[keep].astype(np.float32)
            terms.append(("exception", pe,
                          np.stack([qq, c6, c12], -1), None))
    if s.thole_sites.shape[0]:
        # prm = (qq, screen); idx = (d1,p1,d2,p2)
        ts = np.asarray(s.thole_sites, np.int32)
        prm = np.stack([np.asarray(s.thole_qq),
                        np.asarray(s.thole_screen)], -1).astype(np.float32)
        ts, prm = _keep("thole", ts, prm)
        if ts.shape[0]:
            terms.append(("thole", ts, prm, None))

    n = s.n_atoms
    # Per-type incidence tables.  Atoms with more than k1 incident slots
    # get ONE "combined" slot: their excess contributions are pre-summed
    # into an extension of the flat array via a second (H,k2) gather, so
    # the whole accumulation is gather-only.
    incidences = []
    total = 0
    for name, idx, prm, _split in terms:
        nt, p = idx.shape
        total += nt * p
        entries = [[] for _ in range(n)]
        for t in range(nt):
            for sl in range(p):
                a = idx[t, sl]
                if a >= 0:
                    entries[a].append(t * p + sl)            # term-major
        counts = np.array([len(e) for e in entries], np.int32)
        kmax = max(int(counts.max()) if n else 1, 1)
        # split chosen to minimize exact gathered-row volume: overflow
        # atoms keep k1-1 direct slots + 1 combined slot of the rest
        best, k1 = None, kmax
        for cand in range(1, kmax + 1):
            over = counts[counts >= cand + 1]
            vol = n * cand + (len(over) * int(over.max() - cand + 1)
                              if len(over) else 0)
            if best is None or vol < best:
                best, k1 = vol, cand
        incidence = np.full((n, k1), -1, np.int32)
        over_rows = []
        for i, e in enumerate(entries):
            if len(e) <= k1:
                incidence[i, :len(e)] = e
            else:
                incidence[i, :k1 - 1] = e[:k1 - 1]
                incidence[i, k1 - 1] = nt * p + len(over_rows)
                over_rows.append(e[k1 - 1:])
        if over_rows:
            k2 = max(len(r) for r in over_rows)
            combine = np.full((len(over_rows), k2), -1, np.int32)
            for r, e in enumerate(over_rows):
                combine[r, :len(e)] = e
        else:
            combine = np.zeros((0, 1), np.int32)
        incidences.append((incidence, combine))
    return terms, incidences, total




def tables_to(terms, incidence, device):
    """Device tensors of ``build_term_tables``' host output: per term
    (name, idx int64, prm f32, split with ``which`` as a tensor) and per
    term the (primary, combine) incidence tables as int64."""
    out_terms = []
    for name, idx, prm, split in terms:
        if split is not None:
            split = (split[0], torch.as_tensor(split[1], device=device))
        out_terms.append((name, torch.as_tensor(idx.astype(np.int64),
                                                device=device),
                          torch.as_tensor(prm, device=device), split))
    out_inc = [(torch.as_tensor(a.astype(np.int64), device=device),
                torch.as_tensor(b.astype(np.int64), device=device))
               for a, b in incidence]
    return out_terms, out_inc


def _gather_sum(table, src):
    """Sum of ``src`` rows named by each row of ``table`` (-1 = none)."""
    rows, k = table.shape
    g = src[torch.clamp(table, min=0).reshape(-1)]
    g = torch.where((table >= 0).reshape(-1, 1), g, torch.zeros_like(g))
    return g.reshape(rows, k, 3).sum(dim=1)


def energies_and_forces(pos, box, terms, incidence):
    """Returns (dict of per-type energy sums, (N,3) forces) for the device
    tables of ``tables_to``."""
    box3 = (box[0], box[1], box[2])
    energies = {}
    forces = torch.zeros_like(pos)
    for (name, idx, prm, split), (inc_t, combine) in zip(terms, incidence):
        fn, _ = _TERM_FNS[name]
        mask = idx[:, 0] >= 0
        pts = pos[torch.clamp(idx, min=0)]                 # (NT,P,3)
        e_t, grads = fn(lambda a, b: _delta(pts, a, b, box3), prm)
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        if name == "exception":
            e_coul, e_lj = e_t
            energies["exception_coul"] = torch.sum(
                torch.where(mask, e_coul, zero))
            energies["exception_lj"] = torch.sum(torch.where(mask, e_lj, zero))
        else:
            e_m = torch.where(mask, e_t, zero)
            if split is not None:
                (la, lb), which = split
                energies[la] = torch.sum(torch.where(which < 0.5, e_m, zero))
                energies[lb] = torch.sum(torch.where(which >= 0.5, e_m, zero))
            else:
                energies[name] = torch.sum(e_m)
        fmask = mask.to(pos.dtype)
        g_t = torch.stack([torch.stack([gx * fmask, gy * fmask, gz * fmask],
                                       -1) for gx, gy, gz in grads], dim=1)
        flat = g_t.reshape(-1, 3)
        if combine.shape[0]:
            flat = torch.cat([flat, _gather_sum(combine, flat)], dim=0)
        forces = forces - _gather_sum(inc_t, flat)
    return energies, forces
