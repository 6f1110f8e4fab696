"""The exact-k route (``recip="exact"``, the port's matmul sum): the
reference's Ewald reciprocal sum over all atoms on the k lattice
|n_a| <= kmax_a of OpenMM's error estimate, and the route's work count:
the distinct modes of the lattice (half of (2 kx + 1)(2 ky + 1)(2 kz + 1)
- 1, since S(-k) is conj S(k)) times the charged atoms, at ``B4_OPS`` for
the structure factor and ``B5_OPS`` for the forces per (atom, mode).

The sum is two matrix products (structure factor, then forces), so its
precision is that of the products.  The control (``ref.control``) rounds
the operands of every product to TF32's 10-bit mantissa, as the tensor
cores take them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import ONE_4PI_EPS0, ewald_parameters, tf32


# float32 operations per (atom, k) of the factorised exact-k sum (the k list
# is a lattice, so e^{i k.r} = e_x e_y e_z with q folded in once a column):
# the phase 6 and its sum into S 2; the forces' g = a c - b s 3, G += g 1,
# Gz += g nz 2.  A multiply-add counts 2.
B4_OPS, B5_OPS = 8, 12


def kmax_of(t):
    """Per-axis kmax of the tables' cutoff, tolerance and box."""
    return ewald_parameters(t["cutoff"], t["ewald_tolerance"], t["box"])[1]


def kspace_modes(kmax):
    """Distinct nonzero modes of the |n_a| <= kmax_a lattice."""
    a, b, c = (2 * int(k) + 1 for k in kmax)
    return (a * b * c - 1) // 2


def ops(t, kmax=None):
    """float32 operations of the route on the tables ``t``, on the lattice
    of ``kmax`` or of the tables."""
    kmax = kmax_of(t) if kmax is None else kmax
    return (kspace_modes(kmax) * int(np.count_nonzero(t["charges"]))
            * (B4_OPS + B5_OPS))


class Reciprocal:
    """The exact-k sum of the reference ``ref`` (its charges, beta, box,
    dtype and control), on the lattice of ``kmax`` or of the tables."""

    def __init__(self, ref, t, kmax=None):
        self.ref = ref
        self.kmax = tuple(kmax) if kmax is not None else kmax_of(t)

    def mm(self, a, b):
        if self.ref.control:
            a, b = tf32(a), tf32(b)
        return a @ b

    def __call__(self, pos, block=4096):
        """(forces, {"coul_recip": energy}): S(k) by one product of the
        (atoms, kx ky) phases with the (atoms, kz) phases, the forces by
        the product of the (atoms, kz) phases with the weighted S."""
        ref = self.ref
        f = dict(dtype=ref.dtype, device=ref.device)
        k0, k1, k2 = self.kmax
        box = ref.box
        kx = 2.0 * math.pi * torch.arange(-k0, k0 + 1, **f) / box[0]
        ky = 2.0 * math.pi * torch.arange(-k1, k1 + 1, **f) / box[1]
        kz = 2.0 * math.pi * torch.arange(0, k2 + 1, **f) / box[2]
        na, nb, nc = kx.shape[0], ky.shape[0], kz.shape[0]
        k2v = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
               + kz[None, None, :] ** 2)
        # the kz > 0 half counts twice (S(-k) = conj S(k)); k = 0 not at all
        half = torch.full_like(k2v, 2.0)
        half[:, :, 0] = 1.0
        half[k0, k1, 0] = 0.0
        k2s = torch.where(half > 0, k2v, torch.ones_like(k2v))
        w = (half * torch.exp(-k2s / (4.0 * ref.beta ** 2)) / k2s
             ).reshape(na * nb, nc)
        vol = box[0] * box[1] * box[2]
        pref = 2.0 * math.pi * ONE_4PI_EPS0 / vol

        def phases(p):
            cx, sx = torch.cos(p[:, 0:1] * kx), torch.sin(p[:, 0:1] * kx)
            cy, sy = torch.cos(p[:, 1:2] * ky), torch.sin(p[:, 1:2] * ky)
            re = (cx[:, :, None] * cy[:, None, :]
                  - sx[:, :, None] * sy[:, None, :]).reshape(-1, na * nb)
            im = (sx[:, :, None] * cy[:, None, :]
                  + cx[:, :, None] * sy[:, None, :]).reshape(-1, na * nb)
            z = p[:, 2:3] * kz
            return re, im, torch.cat([torch.cos(z), torch.sin(z)], 1)

        n = pos.shape[0]
        prod = torch.zeros((2 * na * nb, 2 * nc), **f)
        for s in range(0, n, block):
            re, im, ez = phases(pos[s:s + block])
            qb = ref.q[s:s + block, None]
            prod = prod + self.mm(torch.cat([qb * re, qb * im], 1).t(), ez)
        ab = na * nb
        s_re = prod[:ab, :nc] - prod[ab:, nc:]
        s_im = prod[:ab, nc:] + prod[ab:, :nc]
        energy = pref * torch.sum(w * (s_re * s_re + s_im * s_im))
        # F_i = 2 pref q_i sum_k k w_k Im(conj(S_k) e^{i k.r_i})
        kxy = torch.stack([kx[:, None].expand(na, nb).reshape(-1),
                           ky[None, :].expand(na, nb).reshape(-1)], 1)
        h_re, h_im = w * s_re, -w * s_im          # w conj(S), (AB, C)
        blocks = []
        for scale in (None, kz):
            hr = h_re if scale is None else h_re * scale
            hi = h_im if scale is None else h_im * scale
            blocks.append(torch.cat([torch.cat([hr.t(), hi.t()], 1),
                                     torch.cat([-hi.t(), hr.t()], 1)], 0))
        hmat = torch.cat(blocks, 1)                # (2C, 4AB)
        out = torch.empty_like(pos)
        for s in range(0, n, block):
            re, im, ez = phases(pos[s:s + block])
            u = self.mm(ez, hmat)
            u_re, u_im = u[:, :ab], u[:, ab:2 * ab]
            uz_re, uz_im = u[:, 2 * ab:3 * ab], u[:, 3 * ab:]
            v_im = re * u_im + im * u_re
            vz_im = re * uz_im + im * uz_re
            qb = 2.0 * pref * ref.q[s:s + block, None]
            out[s:s + block] = qb * torch.cat(
                [v_im @ kxy, torch.sum(vz_im, 1, keepdim=True)], 1)
        return out, {"coul_recip": energy}
