"""The reference of the constant-voltage slab (tables of
``benchmark/layouts/edl_swm4_nacl.py``), on the water's
(``benchmark/references/swm4_ndp.py``): the plain float64 forces and TGNH
middle step of ``benchmark/reference.py``, with

* the images as explicit rows, placed on their parents' mirror after the
  virtual sites are placed, at every force evaluation and after the step:
  the reciprocal is the traffic route's plain sum over every charged row,
  images included, so it takes nothing from the port's mirror route;
* the Lennard-Jones pairs by the Lorentz-Berthelot rule, kept only between
  the pairs of groups the tables allow;
* the Drude wall's force (``wall_lj126``: 4 eps ((s/d)^12 - (s/d)^6 + 1/4)
  within 2^(1/6) sigma of a bound, d the distance to it), under the name
  the port gives its first external;
* the field in the step: q E along z on every liquid row, 96.4853 kJ/mol
  per e V, a virtual site's share on its parents by its weights;
* the electrode massless, so that nothing moves it.

Its numbers are the water's (``constraint_rel``, ``drude_nm``,
``temp_drude_k``) and ``image_gap_nm``: the widest distance of an image's
row in the port's window-end state from its parent's mirror, the parents'
virtual sites placed (an M site's image included: its row is what the
port's image sync wrote).  The control is the same code in float32 with
the exact-k route's TF32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import reference
from benchmark.references import swm4_ndp

# kJ/mol of one e across one V
E_VOLT = 96.4853400990037
# the most the carried rounding of two float32 rows below 8 nm (half an
# ulp, 2.4e-7 nm, an axis) moves their distance: the port's hard wall acts
# on the float32 rows, and a Drude at its wall may read this far beyond it
WALL_ROUNDING_NM = 1e-6


class Reference(swm4_ndp.Reference):
    def __init__(self, t, traffic, device, **kw):
        super().__init__(t, traffic, device, **kw)
        f = dict(dtype=self.dtype, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        # Lorentz-Berthelot by type, folded with the groups into one pair
        # table over (type, group)
        sig, eps = np.asarray(t["lj_sigma"]), np.asarray(t["lj_epsilon"])
        groups = np.asarray(t["lj_group"])
        n_g = int(groups.max()) + 1
        allowed = np.zeros((n_g, n_g), bool)
        for a, b in np.asarray(t["lj_group_pairs"]).tolist():
            allowed[a, b] = allowed[b, a] = True
        sig_ij = 0.5 * (sig[:, None] + sig[None, :])
        eps_ij = np.sqrt(np.outer(eps, eps))
        everywhere = np.ones((1, n_g, 1, n_g))
        self.nt = sig.size * n_g
        self.eps4 = torch.as_tensor((4.0 * eps_ij[:, None, :, None]
                                     * allowed[None, :, None, :]).reshape(-1),
                                    **f)
        self.sig2 = torch.as_tensor(((sig_ij ** 2)[:, None, :, None]
                                     * everywhere).reshape(-1), **f)
        self.ty = torch.as_tensor(np.asarray(t["lj_type"]) * n_g + groups,
                                  **i64)
        pairs = np.asarray(t["image_pairs"], np.int64)
        self.parents = torch.as_tensor(pairs[:, 0], **i64)
        self.images = torch.as_tensor(pairs[:, 1], **i64)
        self.zm = float(t["mirror_nm"])
        w = t["wall"]
        self.wall = (torch.as_tensor(np.asarray(w["particles"]), **i64),
                     w["axis"], w["bound"], w["epsilon"], w["sigma"])
        field = np.zeros(self.n)
        field[np.asarray(t["liquid"])] = (
            E_VOLT * float(traffic["voltage_v"]) * 2.0 / t["box"][2])
        fz = torch.as_tensor(field, **f) * self.q
        self.field = self.to_parents(torch.stack(
            [torch.zeros_like(fz), torch.zeros_like(fz), fz], 1))

    def _thermostat_tables(self, t):
        """The water's groups over the liquid's molecules: an electrode
        row, in no molecule, is counted in molecule 0, where its zero mass
        changes nothing."""
        mol = np.asarray(t["molecule"])
        super()._thermostat_tables(dict(t, molecule=np.where(mol < 0, 0,
                                                             mol)))

    def mirror(self, pos):
        """The parents' mirror images: x, y kept, z -> 2 zm - z."""
        p = pos[self.parents]
        return torch.cat([p[:, :2], 2.0 * self.zm - p[:, 2:]], 1)

    def place_vsites(self, pos):
        """The virtual sites placed, then the images on their parents'
        mirror."""
        pos = super().place_vsites(pos)
        return pos.index_put((self.images,), self.mirror(pos))

    def to_parents(self, f):
        """``f`` with each virtual site's row moved onto its parents by its
        weights."""
        f_site = f[self.vsites]
        f = f.index_put((self.vsites,), torch.zeros_like(f_site))
        return f.index_add(0, self.vparents.reshape(-1), (
            self.vweights[:, :, None] * f_site[:, None, :]).reshape(-1, 3))

    def wall_forces(self, pos):
        """(forces, energy) of the Drude wall."""
        idx, axis, (lo, hi), eps, sigma = self.wall
        x = pos[idx, axis]
        cut = sigma * 2.0 ** (1.0 / 6.0)
        f = torch.zeros_like(x)
        e = torch.zeros((), dtype=pos.dtype, device=pos.device)
        for dist, sign in ((x - lo, 1.0), (hi - x, -1.0)):
            near = dist < cut
            r6 = (sigma / torch.where(near, dist, torch.ones_like(dist))) ** 6
            f = f + torch.where(near, sign * 4.0 * eps * (12.0 * r6 * r6
                                                         - 6.0 * r6) / dist,
                                0.0)
            e = e + torch.sum(torch.where(near, 4.0 * eps * (r6 * r6 - r6
                                                             + 0.25), 0.0))
        out = torch.zeros_like(pos)
        out[idx, axis] = f
        return out, e

    def forces(self, pos, box=None):
        f, e = super().forces(pos, box)
        f_wall, e["external_0"] = self.wall_forces(pos)
        return f + f_wall, e

    def step(self, s, forces):
        """The water's step with the field in its kick, the images
        re-placed after it."""
        pos, vel = super().step(s, forces + self.field.to(forces.dtype))
        return self.place_vsites(pos), vel

    def stated_limits(self):
        """The wall's distance and the rounding of the rows it acts on: in
        the slab the Drudes ride the wall."""
        return {"drude_nm": self.dmax + WALL_ROUNDING_NM}

    def numbers(self, s):
        out = super().numbers(s)
        x = s["pos"] + s["pos_err"]
        placed = reference.Reference.place_vsites(self, x)
        gap = torch.sqrt(torch.sum((x[self.images] - self.mirror(placed))
                                   ** 2, 1))
        out["image_gap_nm"] = float(gap.max())
        return out


def build(t, traffic, device, control=False):
    """The reference of the tables ``t`` on the traffic's route, or with
    ``control`` its control."""
    if control:
        return Reference(t, traffic, device, dtype=torch.float32,
                         control=True)
    return Reference(t, traffic, device)
