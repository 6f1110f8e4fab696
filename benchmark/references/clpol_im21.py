"""The reference of the CL&Pol ionic liquid (tables of
``benchmark/layouts/clpol_im21.py``), on the water's
(``benchmark/references/swm4_ndp.py``): the plain float64 forces and TGNH
middle step of ``benchmark/reference.py``, with

* the Lennard-Jones epsilon of each pair of types scaled by CL&Pol's k_ij
  (``lj_k``), sigma geometric;
* beside the Drude springs, the flexible molecule's terms, whose forces
  autograd takes:
  - bonds E = k (r - r0)^2 / 2 and angles E = k (theta - theta0)^2 / 2;
  - OPLS torsions E = V1 (1 + cos phi) / 2 + V2 (1 - cos 2 phi) / 2
    + V3 (1 + cos 3 phi) / 2 + V4 (1 - cos 4 phi) / 2, reported as
    ``dihedral``, and impropers E = V2 (1 - cos 2 phi) / 2;
  - Thole's screened interaction of the induced dipoles of each 1-2 and
    1-3 pair of polarizable atoms: each dipole a Drude's charge q_D on the
    Drude and -q_D on its core, each of the four charge pairs
    q q' / (4 pi eps0 r) (1 - (1 + u / 2) e^-u), u = a r / (alpha
    alpha')^(1/6);
  - the 1-4 pairs of atoms: plain Coulomb x 0.5 between every charge site
    of the one atom (the core and its Drude) and every one of the other's
    (``exception_coul``), and Lennard-Jones x 0.5 between the two atoms,
    epsilon unscaled by k_ij (``exception_lj``).

The force gaps' allowance at the cutoff (``band``) also takes the pairs
just outside it, within ``cutoff_band``: a float32 distance may put such a
pair inside, where the port counts its force (a Drude and a core 1.2 +
2.5e-8 nm apart, 1.6 kJ/mol/nm, read on an NVIDIA H100); the base counts
only those just inside.

Its numbers are the water's (``constraint_rel``, ``drude_nm``,
``temp_drude_k``).  The control is the same code in float32 with the
exact-k route's TF32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ONE_4PI_EPS0, SQRT_PI
from benchmark.references import swm4_ndp


def dihedral_angle(p0, p1, p2, p3, mi):
    """The dihedral angle of each row's four points (0 cis, pi trans)."""
    b1, b2, b3 = mi(p1 - p0), mi(p2 - p1), mi(p3 - p2)
    n1, n2 = torch.cross(b1, b2, dim=-1), torch.cross(b2, b3, dim=-1)
    y = torch.norm(b2, dim=-1) * torch.sum(b1 * n2, -1)
    return torch.atan2(y, torch.sum(n1 * n2, -1))


class Reference(swm4_ndp.Reference):
    def __init__(self, t, traffic, device, **kw):
        super().__init__(t, traffic, device, **kw)
        f = dict(dtype=self.dtype, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        eps = np.asarray(t["lj_epsilon"], np.float64)
        self.eps4 = torch.as_tensor(4.0 * np.asarray(t["lj_k"])
                                    * np.sqrt(np.outer(eps, eps)),
                                    **f).reshape(-1)

        def ix(key):
            return torch.as_tensor(np.asarray(t[key], np.int64), **i64)

        def fl(key):
            return torch.as_tensor(np.asarray(t[key], np.float64), **f)
        self.bonds, self.bond_r0, self.bond_k = (ix("bonds"), fl("bond_r0"),
                                                 fl("bond_k"))
        self.angles, self.angle_th0, self.angle_k = (
            ix("angles"), fl("angle_theta0"), fl("angle_k"))
        self.torsions, self.torsion_v = ix("torsions"), fl("torsion_v")
        self.impropers, self.improper_v2 = ix("impropers"), fl("improper_v2")
        # the Thole pairs' dipoles: (Drude, core, q_D, alpha) of each side
        dr = np.asarray(t["drudes"], np.int64)
        of = {int(p): k for k, p in enumerate(dr[:, 1])}
        tp = np.asarray(t["thole_pairs"], np.int64).reshape(-1, 2)
        k1 = np.array([of[p] for p in tp[:, 0]], np.int64)
        k2 = np.array([of[p] for p in tp[:, 1]], np.int64)
        q_d, alpha = (np.asarray(t["drude_charge"], np.float64),
                      np.asarray(t["drude_alpha"], np.float64))
        self.thole_sites = torch.as_tensor(np.stack(
            [dr[k1, 0], dr[k1, 1], dr[k2, 0], dr[k2, 1]], 1), **i64)
        self.thole_qq = torch.as_tensor(q_d[k1] * q_d[k2], **f)
        self.thole_u = torch.as_tensor(
            t["thole_a"] / (alpha[k1] * alpha[k2]) ** (1.0 / 6.0), **f)
        # the 1-4 pairs: Coulomb between every charge site of the two atoms
        q = np.asarray(t["charges"], np.float64)
        drude_of = {int(p): int(d) for d, p in dr.tolist()}
        coul = []
        for a, b in np.asarray(t["pairs14"], np.int64).tolist():
            for x in [a] + ([drude_of[a]] if a in drude_of else []):
                for y in [b] + ([drude_of[b]] if b in drude_of else []):
                    coul.append((x, y))
        coul = np.asarray(coul, np.int64).reshape(-1, 2)
        self.coul14 = torch.as_tensor(coul, **i64)
        self.coul14_qq = torch.as_tensor(
            t["scale14_coulomb"] * ONE_4PI_EPS0 * q[coul[:, 0]]
            * q[coul[:, 1]], **f)
        p14 = np.asarray(t["pairs14"], np.int64).reshape(-1, 2)
        ty = np.asarray(t["lj_type"], np.int64)
        sig = np.asarray(t["lj_sigma"], np.float64)
        self.lj14 = torch.as_tensor(p14, **i64)
        self.lj14_sig2 = torch.as_tensor(sig[ty[p14[:, 0]]]
                                         * sig[ty[p14[:, 1]]], **f)
        self.lj14_eps4 = torch.as_tensor(
            4.0 * t["scale14_lj"] * np.sqrt(eps[ty[p14[:, 0]]]
                                            * eps[ty[p14[:, 1]]]), **f)

    def direct(self, pos):
        """The base's sweep, and into ``self.band`` each atom's summed force
        of its pairs at most ``cutoff_band`` beyond the cutoff."""
        f_out, e = super().direct(pos)
        rc, beta = self.rc, self.beta
        for s in range(0, self.n, self.rows):
            e_ = min(self.n, s + self.rows)
            d = self.mi(pos[s:e_, None, :] - pos[None, :, :])
            r = torch.sqrt(torch.sum(d * d, -1))
            out = ((r >= rc) & (r < rc + self.cutoff_band)
                   & ~self._excluded_block(s, e_))
            if not bool(out.any()):
                continue
            r = torch.where(out, r, torch.full_like(r, rc))
            qq = ONE_4PI_EPS0 * self.q[s:e_, None] * self.q[None, :]
            fc = qq * (torch.special.erfc(beta * r) / r + 2.0 * beta
                       / SQRT_PI * torch.exp(-(beta * r) ** 2)) / r
            pair_t = self.ty[s:e_, None] * self.nt + self.ty[None, :]
            sr6 = (self.sig2[pair_t] / r ** 2) ** 3
            fl = self.eps4[pair_t] * (12.0 * sr6 * sr6 - 6.0 * sr6) / r
            self.band[s:e_] += torch.sum(torch.where(
                out, torch.abs(fc + fl), torch.zeros_like(r)), 1)
        return f_out, e

    def _dist(self, pos, pairs):
        d = self.mi(pos[pairs[:, 0]] - pos[pairs[:, 1]])
        return torch.sqrt(torch.sum(d * d, -1))

    def bonded_energy(self, pos):
        """The Drude springs and the flexible molecule's terms (see the
        module doc), by name."""
        out = super().bonded_energy(pos)
        r = self._dist(pos, self.bonds)
        out["bond"] = 0.5 * torch.sum(self.bond_k * (r - self.bond_r0) ** 2)
        i, j, k = self.angles.unbind(1)
        u, v = self.mi(pos[i] - pos[j]), self.mi(pos[k] - pos[j])
        theta = torch.atan2(torch.norm(torch.cross(u, v, dim=-1), dim=-1),
                            torch.sum(u * v, -1))
        out["angle"] = 0.5 * torch.sum(self.angle_k
                                       * (theta - self.angle_th0) ** 2)
        phi = dihedral_angle(*(pos[c] for c in self.torsions.unbind(1)),
                             self.mi)
        v = self.torsion_v
        out["dihedral"] = 0.5 * torch.sum(
            v[:, 0] * (1.0 + torch.cos(phi)) + v[:, 1] * (1.0 - torch.cos(
                2.0 * phi)) + v[:, 2] * (1.0 + torch.cos(3.0 * phi))
            + v[:, 3] * (1.0 - torch.cos(4.0 * phi)))
        psi = dihedral_angle(*(pos[c] for c in self.impropers.unbind(1)),
                             self.mi)
        out["improper"] = 0.5 * torch.sum(self.improper_v2
                                          * (1.0 - torch.cos(2.0 * psi)))
        d1, p1, d2, p2 = self.thole_sites.unbind(1)
        e = torch.zeros((), dtype=pos.dtype, device=pos.device)
        for a, b, sign in ((d1, d2, 1.0), (d1, p2, -1.0), (p1, d2, -1.0),
                           (p1, p2, 1.0)):
            dd = self.mi(pos[a] - pos[b])
            rr = torch.sqrt(torch.sum(dd * dd, -1))
            x = self.thole_u * rr
            e = e + torch.sum(sign * ONE_4PI_EPS0 * self.thole_qq / rr
                              * (1.0 - (1.0 + 0.5 * x) * torch.exp(-x)))
        out["thole"] = e
        out["exception_coul"] = torch.sum(
            self.coul14_qq / self._dist(pos, self.coul14))
        sr6 = (self.lj14_sig2 / self._dist(pos, self.lj14) ** 2) ** 3
        out["exception_lj"] = torch.sum(self.lj14_eps4 * (sr6 * sr6 - sr6))
        return out


def build(t, traffic, device, control=False):
    """The reference of the tables ``t`` on the traffic's route, or with
    ``control`` its control."""
    if control:
        return Reference(t, traffic, device, dtype=torch.float32,
                         control=True)
    return Reference(t, traffic, device)
