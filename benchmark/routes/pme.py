"""The smooth-PME route (``recip="pme"``): the reference's reciprocal sum
by smooth particle-mesh Ewald after Essmann, Perera, Berkowitz, Darden,
Lee and Pedersen, J. Chem. Phys. 103, 8577 (1995), and the route's work
count: on a grid of K points, the spread and the gather, order^3
multiply-adds a charged atom each; the forward and the inverse 3-D real
FFT, 2.5 K log2 K each; the convolution, K.

* The grid: per axis the smallest K with no prime factor but 2, 3 and 5
  and a spacing L / K of at most ``SPACING_NM`` (at least 4 points), the
  rule the port's route states.
* The charges are spread by cardinal B-splines of order ``ORDER``: with
  u = K r / L in grid units, an atom adds q M_n(u - k) to the points
  k = floor(u) - j, j = 0 .. n - 1, wrapped (eq. 4.6).  M_n comes from
  the recursion M_n(x) = (x M_{n-1}(x) + (n - x) M_{n-1}(x - 1)) / (n - 1)
  with M_2(x) = 1 - |x - 1| on [0, 2], and dM_n/dx = M_{n-1}(x)
  - M_{n-1}(x - 1).
* E = C / (2 pi V) sum_{m != 0} exp(-pi^2 m^2 / beta^2) / m^2 B(m)
  |F(Q)(m)|^2 (eq. 4.7), with m the reciprocal vector (m_x / L_x, ...),
  B(m) the product of the axes' Euler exponential-spline factors
  |b(m)|^2 = 1 / |sum_{j=0}^{n-2} M_n(j + 1) exp(2 pi i m j / K)|^2, and
  C the Coulomb constant.
* Forces are the analytic gradient (eq. 4.9): phi = theta_rec * Q, the
  convolution by one forward and one inverse FFT, and F_i = -sum_k
  dQ(k)/dr_i phi(k), gathered at each atom's n^3 points.

The control (``ref.control``, float32) rounds to bfloat16 the spread's
operands (charge x weight), each FFT's input and the gather's weights:
the route has no matrix product for TF32 to round.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import ONE_4PI_EPS0

ORDER = 4
SPACING_NM = 0.10


def smooth(k):
    for f in (2, 3, 5):
        while k % f == 0:
            k //= f
    return k == 1


def grid(box, spacing=SPACING_NM):
    """(Kx, Ky, Kz) of the grid rule for the box's edges."""
    dims = []
    for length in np.asarray(box, np.float64).reshape(-1)[:3]:
        k = max(math.ceil(length / spacing), 4)
        while not smooth(k):
            k += 1
        dims.append(k)
    return tuple(dims)


def ops(t, dims=None):
    """float32 operations of the route on the tables ``t``, on the grid
    ``dims`` or the rule's for the tables' box: the spread and the gather
    at 2 a multiply-add, the two FFTs and the convolution's K products."""
    k = math.prod(grid(t["box"]) if dims is None else dims)
    n_charged = int(np.count_nonzero(t["charges"]))
    return 2 * n_charged * ORDER ** 3 * 2 + 2 * 2.5 * k * math.log2(k) + k


def bspline(x, n):
    """The cardinal B-spline M_n at ``x`` (zero outside [0, n])."""
    if n == 2:
        return torch.clamp(1.0 - torch.abs(x - 1.0), min=0.0)
    return (x * bspline(x, n - 1) + (n - x) * bspline(x - 1.0, n - 1)) / (
        n - 1)


def euler_factors(k, n=ORDER):
    """|b(m)|^2 for m = 0 .. K - 1, numpy float64."""
    nodes = bspline(torch.arange(1, n, dtype=torch.float64), n).numpy()
    m = np.arange(k)[:, None]
    s = np.sum(nodes * np.exp(2j * np.pi * m * np.arange(n - 1) / k), 1)
    return 1.0 / np.abs(s) ** 2


def bf16(x):
    """``x`` rounded to bfloat16 (nearest, ties to even), kept in its
    dtype; a complex ``x`` by its parts."""
    if x.is_complex():
        return torch.complex(bf16(x.real), bf16(x.imag))
    return x.to(torch.bfloat16).to(x.dtype)


class Reciprocal:
    """Smooth PME of the reference ``ref`` (its charges, beta, box, dtype
    and control) on the grid of ``spacing`` over the tables' box."""

    def __init__(self, ref, t, spacing=SPACING_NM):
        self.ref = ref
        self.grid = grid(t["box"], spacing)
        f = dict(dtype=ref.dtype, device=ref.device)
        ex, ey, ez = (euler_factors(k) for k in self.grid)
        self.b2 = torch.as_tensor(ex[:, None, None] * ey[None, :, None]
                                  * ez[None, None, :], **f)
        self.freq = [torch.as_tensor(np.fft.fftfreq(k) * k, **f)
                     for k in self.grid]

    def round(self, x):
        return bf16(x) if self.ref.control else x

    def __call__(self, pos):
        """(forces, {"coul_recip": energy})."""
        ref, n = self.ref, ORDER
        f = dict(dtype=ref.dtype, device=ref.device)
        box = ref.box
        kk = torch.as_tensor(self.grid, **f)
        u = torch.remainder(pos / box * kk, kk)
        cell = torch.floor(u)
        j = torch.arange(n, **f)
        x = (u - cell)[:, :, None] + j                      # (N, 3, n)
        theta = bspline(x, n)
        dtheta = bspline(x, n - 1) - bspline(x - 1.0, n - 1)
        ki = torch.as_tensor(self.grid, device=ref.device)[None, :, None]
        pts = torch.remainder(cell.to(torch.int64)[:, :, None]
                              - torch.arange(n, device=ref.device), ki)
        kx, ky, kz = self.grid
        flat = ((pts[:, 0, :, None, None] * ky + pts[:, 1, None, :, None])
                * kz + pts[:, 2, None, None, :]).reshape(-1)
        tx, ty, tz = theta[:, 0], theta[:, 1], theta[:, 2]
        w = (tx[:, :, None, None] * ty[:, None, :, None]
             * tz[:, None, None, :])
        val = self.round(ref.q[:, None, None, None] * w)
        q_grid = torch.zeros(kx * ky * kz, **f).index_add_(
            0, flat, val.reshape(-1)).reshape(kx, ky, kz)
        s = torch.fft.fftn(self.round(q_grid))
        mx, my, mz = (fr / box[a] for a, fr in enumerate(self.freq))
        m2 = (mx[:, None, None] ** 2 + my[None, :, None] ** 2
              + mz[None, None, :] ** 2)
        live = m2 > 0
        m2s = torch.where(live, m2, torch.ones_like(m2))
        vol = box[0] * box[1] * box[2]
        d = torch.where(live, ONE_4PI_EPS0 / (math.pi * vol) * torch.exp(
            -math.pi ** 2 * m2s / ref.beta ** 2) / m2s * self.b2,
            torch.zeros_like(m2))
        energy = 0.5 * torch.sum(d * (s.real ** 2 + s.imag ** 2))
        phi = torch.fft.ifftn(self.round(d * s)).real * (kx * ky * kz)
        at = phi.reshape(-1)[flat].reshape(-1, n, n, n)
        dx, dy, dz = dtheta[:, 0], dtheta[:, 1], dtheta[:, 2]
        grads = (dx[:, :, None, None] * ty[:, None, :, None]
                 * tz[:, None, None, :],
                 tx[:, :, None, None] * dy[:, None, :, None]
                 * tz[:, None, None, :],
                 tx[:, :, None, None] * ty[:, None, :, None]
                 * dz[:, None, None, :])
        out = torch.stack([torch.sum(self.round(g) * at, (1, 2, 3))
                           for g in grads], 1)
        return -ref.q[:, None] * kk / box * out, {"coul_recip": energy}
