"""Smooth particle-mesh Ewald (FFT) reciprocal space (counterpart of
``openmm_velocityverlet_tpu/ops/pme.py``): the reference's own
electrostatics (OpenMM PME, oplspsffile.py:1174-1187) behind the interface
of the exact k-space sum (``ops/ewald.py``), selected by
``recip="pme"``, or by ``"auto"`` through ``choose_reciprocal``'s cost
model of the two routes on the card.

Formulation: Essmann et al. 1995 smooth PME, B-spline order 4.

    E = C * 2 pi / V * sum_{m != 0} exp(-k^2 / 4 beta^2) / k^2 * |S(m)|^2
    S(m) = FFT(Q)[m] / (bx(mx) by(my) bz(mz))

with Q the B-spline-spread charge grid and b the Euler spline factors.
The grid, the spline weights and the Euler factors are the JAX package's,
computed the same way on the host (the grid fixes the result).  Spreading
is one flattened ``index_add`` of the 64 updates per atom; the z-binned
matmul spreading (``bin_cap``) is kept beside it, with the scatter's result
selected on the device where a plane's bin overflows.  The transform is
``torch.fft.fftn`` on complex64, and forces come from
``torch.autograd.grad``.  Torch operations only: the JAX package has no
Pallas kernel here.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..units import ONE_4PI_EPS0, PI

# The cost model: microseconds of each route (energy and autograd forces,
# one call each) on an NVIDIA H100 80GB HBM3 at 700 W, fitted by
# chip_smoke.py's ``recip_fit`` to the route times it measures (PERF.md
# section 6).  The JAX package's model has no fixed term; on the card each
# route carries one (its launches), and below 12 nm the PME route's time is
# that term alone.  The exact sum (the matmul route, ops/ewald.py): a fixed
# part, the bytes of its (n, 2AB) phase block x3 (the backward), and the
# contraction's operations x3.  PME: a fixed part, 64 spread updates an
# atom x2, and four FFT passes of 5 K log2 K butterflies.
EXACT_FIXED_US = 5167.0
EXACT_US_PER_BYTE = 9.923e-6
EXACT_US_PER_FLOP = 0.0
PME_FIXED_US = 3490.0
PME_US_PER_ROW = 0.0
PME_US_PER_BUTTERFLY = 0.0


def choose_grid(box, spacing: float = 0.10) -> tuple:
    """FFT-friendly grid dims (factors 2/3/5 only) with mesh spacing <=
    ``spacing`` nm (OpenMM default PME mesh density is ~1 point/A)."""
    def good(k):
        for f in (2, 3, 5):
            while k % f == 0:
                k //= f
        return k == 1

    dims = []
    for L in np.asarray(box, np.float64).reshape(-1)[:3]:
        k = max(int(math.ceil(L / spacing)), 4)
        while not good(k):
            k += 1
        dims.append(k)
    return tuple(dims)


def _bspline4(t):
    """Order-4 cardinal B-spline weights at fractional offset t in [0,1):
    w[..., 4] for grid points floor(u) - 1 .. floor(u) + 2."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0          # (1-t)^3/6
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w3 = t3 / 6.0
    return torch.stack([w0, w1, w2, w3], dim=-1)


@functools.lru_cache(maxsize=16)
def _euler_factors(K: int, order: int = 4):
    """|b(m)|^2 denominators for one axis (numpy float64, host)."""
    # M_4 at the integer nodes 1, 2, 3
    mvals = np.array([1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0])
    m = np.arange(K)
    denom = np.zeros(K, np.complex128)
    for el, mv in enumerate(mvals):
        denom += mv * np.exp(2j * np.pi * m * el / K)
    return 1.0 / np.maximum(np.abs(denom) ** 2, 1e-14)


@functools.lru_cache(maxsize=16)
def _grid_tables(grid, device):
    """(m_x, m_y, m_z) signed mode numbers, the (Kx, Ky, Kz) product of the
    Euler factors and the grid dims (3,), float32 on ``device``: uploaded
    once, since a host-to-device copy waits for the stream."""
    f32 = dict(dtype=torch.float32, device=device)
    modes = tuple(torch.as_tensor(np.fft.fftfreq(k) * k, **f32)
                  for k in grid)
    b2 = (_euler_factors(grid[0])[:, None, None]
          * _euler_factors(grid[1])[None, :, None]
          * _euler_factors(grid[2])[None, None, :])
    return modes, torch.as_tensor(b2, **f32), torch.as_tensor(grid, **f32)


def _fractional(pos, box, grid):
    """Spline weights (n, 3, 4) and first grid point (n, 3) int64."""
    u = pos / box * _grid_tables(grid, pos.device)[2]
    cell = torch.floor(u)
    return _bspline4(u - cell), cell.to(torch.int64) - 1


def _spread(pos, box, charges, grid):
    """B-spline charge spreading -> (Kx, Ky, Kz) grid: the 64 updates of
    every atom through one flattened ``index_add``, differentiable in
    ``pos``.  ``torch.remainder`` wraps as JAX's floor-mod ``jnp.mod``
    does (``torch.fmod`` would misplace a negative first grid point)."""
    Kx, Ky, Kz = grid
    w, base = _fractional(pos, box, grid)
    offs = torch.arange(4, device=pos.device)
    ix = torch.remainder(base[:, 0:1] + offs, Kx)
    iy = torch.remainder(base[:, 1:2] + offs, Ky)
    iz = torch.remainder(base[:, 2:3] + offs, Kz)
    val = (charges[:, None, None, None]
           * w[:, 0, :, None, None] * w[:, 1, None, :, None]
           * w[:, 2, None, None, :])
    flat = ((ix[:, :, None, None] * Ky + iy[:, None, :, None]) * Kz
            + iz[:, None, None, :])
    q_grid = torch.zeros(Kx * Ky * Kz, dtype=pos.dtype, device=pos.device)
    q_grid = q_grid.index_add(0, flat.reshape(-1), val.reshape(-1))
    return q_grid.reshape(Kx, Ky, Kz)


def _plane_binned_tables(pos_z, box_z, Kz, m_cap):
    """(Kz, m_cap) table of atom indices binned by first-touched z plane
    (-1 padded), and the device flag that a plane held more than
    ``m_cap`` atoms.  Sort by plane, then each atom at (plane, rank within
    it); an atom past the capacity lands in a dropped extra column, so
    nothing is read on the host."""
    n = pos_z.shape[0]
    u = pos_z / box_z * Kz
    cz = torch.remainder(torch.floor(u).to(torch.int64) - 1, Kz)
    order = torch.argsort(cz, stable=True)
    cz_s = cz[order]
    first = torch.searchsorted(cz_s, cz_s, side="left")
    rank = torch.arange(n, device=pos_z.device) - first
    ok = rank < m_cap
    table = torch.full((Kz, m_cap + 1), -1, dtype=torch.int64,
                       device=pos_z.device)
    table[cz_s, torch.clamp(rank, max=m_cap)] = order
    return table[:, :m_cap], torch.any(~ok)


def _spread_binned(pos, box, charges, grid, bins):
    """Scatter-free spreading: plane k = sum_{d=0..3} Wx(bin k-d)^T
    diag(q wz_d) Wy(bin k-d), four batched matmuls over the (Kz, M) bins
    of ``_plane_binned_tables``, which must come from this ``pos`` (the
    landing plane is the bin's row)."""
    Kx, Ky, Kz = grid
    w, base = _fractional(pos, box, grid)
    idx = torch.clamp(bins, min=0)
    mask = (bins >= 0).to(pos.dtype)[..., None]
    bx = base[idx, 0]
    by = base[idx, 1]
    gx = torch.arange(Kx, device=pos.device)
    gy = torch.arange(Ky, device=pos.device)
    wx = torch.zeros(bins.shape + (Kx,), dtype=pos.dtype, device=pos.device)
    wy = torch.zeros(bins.shape + (Ky,), dtype=pos.dtype, device=pos.device)
    for d in range(4):
        selx = torch.remainder(bx[..., None] + d, Kx) == gx
        sely = torch.remainder(by[..., None] + d, Ky) == gy
        wx = wx + selx * w[idx, 0, d][..., None]
        wy = wy + sely * w[idx, 1, d][..., None]
    wx = wx * mask
    qwz = charges[idx][..., None] * w[idx, 2, :] * mask
    planes = torch.zeros((Kz, Kx, Ky), dtype=pos.dtype, device=pos.device)
    for d in range(4):
        contrib = torch.einsum("kmx,km,kmy->kxy", wx, qwz[..., d], wy)
        planes = planes + torch.roll(contrib, d, dims=0)
    return planes.permute(1, 2, 0)


def reciprocal_energy_pme(pos, box, charges, beta, grid, bin_cap=None):
    """PME reciprocal energy, differentiable in ``pos`` (forces by
    ``torch.autograd.grad``).  ``bin_cap``: a per-plane atom capacity that
    takes the binned spreading; its table is built from ``pos`` in the
    call, and where a plane overflows the scatter's grid is taken instead,
    selected on the device."""
    grid = tuple(int(k) for k in grid)
    if bin_cap is not None:
        bins, overflow = _plane_binned_tables(pos[:, 2].detach(), box[2],
                                              grid[2], int(bin_cap))
        q_grid = torch.where(overflow, _spread(pos, box, charges, grid),
                             _spread_binned(pos, box, charges, grid, bins))
    else:
        q_grid = _spread(pos, box, charges, grid)
    F = torch.fft.fftn(q_grid.to(torch.complex64))
    (mx, my, mz), b2, _ = _grid_tables(grid, pos.device)
    kx = (2.0 * PI / box[0]) * mx
    ky = (2.0 * PI / box[1]) * my
    kz = (2.0 * PI / box[2]) * mz
    k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kz[None, None, :] ** 2)
    mask = k2 > 1e-10
    k2s = torch.where(mask, k2, torch.ones_like(k2))
    w = torch.where(mask, torch.exp(-k2s / (4.0 * beta * beta)) / k2s,
                    torch.zeros_like(k2))
    vol = box[0] * box[1] * box[2]
    s2 = F.real ** 2 + F.imag ** 2
    return ONE_4PI_EPS0 * 2.0 * PI / vol * torch.sum(w * b2 * s2)


def _exact_terms(n_atoms, kmax):
    """(1, bytes, operations) of the matmul route."""
    A = 2 * kmax[0] + 1
    B = 2 * kmax[1] + 1
    C = kmax[2] + 1
    return (1.0, n_atoms * 2 * A * B * 4 * 3,
            n_atoms * 2 * A * B * 2 * C * 2 * 3)


def _pme_terms(n_atoms, grid):
    """(1, spread updates, butterflies) of the PME route."""
    k3 = grid[0] * grid[1] * grid[2]
    return 1.0, n_atoms * 64 * 2, 5 * k3 * math.log2(max(k3, 2)) * 4


def exact_sum_cost(n_atoms, kmax):
    """Modelled microseconds of the matmul route on the card."""
    return float(np.dot(_exact_terms(n_atoms, kmax), (
        EXACT_FIXED_US, EXACT_US_PER_BYTE, EXACT_US_PER_FLOP)))


def pme_cost(n_atoms, grid):
    """Modelled microseconds of the PME route on the card."""
    return float(np.dot(_pme_terms(n_atoms, grid), (
        PME_FIXED_US, PME_US_PER_ROW, PME_US_PER_BUTTERFLY)))


def choose_reciprocal(n_atoms, kmax, box, spacing=0.10):
    """('exact' or 'pme', the PME grid): the cheaper route by the cost
    models above."""
    grid = choose_grid(box, spacing)
    return ("pme" if pme_cost(n_atoms, grid)
            < exact_sum_cost(n_atoms, kmax) else "exact"), grid
