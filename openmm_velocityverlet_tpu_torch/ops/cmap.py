"""CMAP torsion cross-terms (CHARMM correction maps; counterpart of
``openmm_velocityverlet_tpu/ops/cmap.py``).

Each cross-term is 8 atom indices, two dihedrals phi = atoms[:4] and psi =
atoms[4:] (oplspsffile.py:430-465), interpolated on its map by a bicubic
patch per grid cell whose knot derivatives come from periodic cubic splines
(OpenMM's CMAPTorsionForce, oplspsffile.py:1134-1169).  The spline fit runs
on the host in float64 at build time, the same code as the JAX package,
giving one (R, R, 4, 4) monomial-coefficient tensor per map; on the device
a term is two dihedral angles, one (4, 4) coefficient gather and a 16-term
polynomial, with forces by ``torch.autograd.grad`` beside the other smooth
terms.

Grid convention: index 0 of each axis is the angle -pi, spacing 2 pi / R
(the CHARMM .prm layout).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..units import PI
# the JAX package's cmap takes its angle from ops/bonded too
from .bonded import _dihedral_angle as dihedral_angle


# ---------------------------------------------------------------- host side

def periodic_spline_slopes(y, axis=0):
    """Knot first-derivatives (index units, h = 1) of the periodic cubic
    spline through ``y`` along ``axis``: the cyclic tridiagonal system
    d_{i-1} + 4 d_i + d_{i+1} = 3 (y_{i+1} - y_{i-1}), solved densely (R <=
    24 for every CHARMM map)."""
    y = np.asarray(y, np.float64)
    y = np.moveaxis(y, axis, 0)
    n = y.shape[0]
    A = 4.0 * np.eye(n)
    idx = np.arange(n)
    A[idx, (idx + 1) % n] = 1.0
    A[idx, (idx - 1) % n] = 1.0
    rhs = 3.0 * (np.roll(y, -1, 0) - np.roll(y, 1, 0))
    d = np.linalg.solve(A, rhs.reshape(n, -1)).reshape(y.shape)
    return np.moveaxis(d, 0, axis)


@functools.lru_cache(maxsize=1)
def _bicubic_solve_matrix():
    """Inverse of the 16x16 system mapping monomial coefficients c[a,b]
    (E = sum c[a,b] t^a u^b on the unit cell) to the 16 corner constraints
    [f, df/dt, df/du, d2f/dtdu] x [(0,0), (1,0), (0,1), (1,1)]."""
    M = np.zeros((16, 16))
    corners = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)]
    for ci, (t, u) in enumerate(corners):
        for a in range(4):
            for bb in range(4):
                col = 4 * a + bb
                ta = t ** a
                ub = u ** bb
                dta = a * t ** (a - 1) if a else 0.0
                dub = bb * u ** (bb - 1) if bb else 0.0
                M[ci, col] = ta * ub
                M[4 + ci, col] = dta * ub
                M[8 + ci, col] = ta * dub
                M[12 + ci, col] = dta * dub
    return np.linalg.inv(M)


def build_cmap_coeffs(grid):
    """(R, R) energy grid -> (R, R, 4, 4) float32 bicubic monomial
    coefficients.  grid[i, j] = E(phi_i, psi_j), phi_i = -pi + 2 pi i / R;
    cell (i, j) covers [phi_i, phi_{i+1}] x [psi_j, psi_{j+1}] in local
    coordinates t, u in [0, 1]; the cross derivative splines the phi-slopes
    along psi."""
    g = np.asarray(grid, np.float64)
    if g.ndim != 2 or g.shape[0] != g.shape[1]:
        raise ValueError(f"CMAP grid must be square, got {g.shape}")
    ft = periodic_spline_slopes(g, axis=0)
    fu = periodic_spline_slopes(g, axis=1)
    ftu = periodic_spline_slopes(ft, axis=1)

    def corners(a):
        a10 = np.roll(a, -1, 0)
        a01 = np.roll(a, -1, 1)
        a11 = np.roll(a10, -1, 1)
        return [a, a10, a01, a11]

    b = np.stack(corners(g) + corners(ft) + corners(fu) + corners(ftu),
                 axis=-1)
    c = b @ _bicubic_solve_matrix().T
    return c.reshape(g.shape[0], g.shape[1], 4, 4).astype(np.float32)


def pack_cmap_maps(grids):
    """(coeffs (M, Rmax, Rmax, 4, 4) f32, res (M,) i32): the maps padded
    with zeros to a common resolution; evaluation indexes with each map's
    own resolution, so the padding is never read."""
    if not grids:
        return (np.zeros((0, 1, 1, 4, 4), np.float32),
                np.zeros((0,), np.int32))
    coeffs = [build_cmap_coeffs(g) for g in grids]
    rmax = max(c.shape[0] for c in coeffs)
    out = np.zeros((len(coeffs), rmax, rmax, 4, 4), np.float32)
    res = np.zeros(len(coeffs), np.int32)
    for m, c in enumerate(coeffs):
        r = c.shape[0]
        out[m, :r, :r] = c
        res[m] = r
    return out, res


# -------------------------------------------------------------- device side

def cmap_energy(pos, box, cmap_atoms, cmap_map, cmap_coeffs, cmap_res):
    """Total CMAP energy, differentiable in ``pos``.  ``cmap_atoms`` (T, 8)
    and ``cmap_map`` (T,) index tables, ``cmap_coeffs`` (M, Rmax, Rmax, 4,
    4) and ``cmap_res`` (M,) from ``pack_cmap_maps``, on ``pos``'s
    device."""
    if cmap_atoms.shape[0] == 0:
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    mask = cmap_atoms[:, 0] >= 0
    safe = torch.where(mask[:, None], cmap_atoms,
                       torch.zeros_like(cmap_atoms))
    phi = dihedral_angle(pos, box, safe[:, :4])
    psi = dihedral_angle(pos, box, safe[:, 4:])
    r = cmap_res[cmap_map]
    rf = r.to(pos.dtype)
    s_phi = (phi + PI) * (rf / (2.0 * PI))
    s_psi = (psi + PI) * (rf / (2.0 * PI))
    i = torch.minimum(torch.floor(s_phi).to(r.dtype).clamp(min=0), r - 1)
    j = torch.minimum(torch.floor(s_psi).to(r.dtype).clamp(min=0), r - 1)
    t = s_phi - i.to(pos.dtype)
    u = s_psi - j.to(pos.dtype)
    c = cmap_coeffs[cmap_map, i, j]
    one = torch.ones_like(t)
    tv = torch.stack([one, t, t * t, t * t * t], -1)
    uv = torch.stack([one, u, u * u, u * u * u], -1)
    e = torch.einsum("tab,ta,tb->t", c, tv, uv)
    return torch.sum(torch.where(mask, e, torch.zeros_like(e)))
