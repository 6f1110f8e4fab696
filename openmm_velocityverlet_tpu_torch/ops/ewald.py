"""Reciprocal-space Ewald sum as matrix products (counterpart of
``openmm_velocityverlet_tpu/ops/ewald.py``).

    E = C/(2V) * sum_{k != 0, |k|<=kc} (4 pi / k^2) exp(-k^2/(4 beta^2)) |S(k)|^2
    S(k) = sum_i q_i exp(i k . r_i)

The k list is a lattice, so a phase factorises: the (m, 2AB) block X of
the charge-weighted (kx, ky) phases (cos and sin) and the (m, 2C) block Y
of the kz >= 0 phases.  The structure factor of the half space is the
(2AB, 2C) product X^T Y, and the gradient follows in closed form from the
same X:

    dE/dr_j = 2 pref q_j sum_k w_k k (S_im(k) cos k.r_j - S_re(k) sin k.r_j)

With the weighted S folded into one (2AB, 6C) matrix G (the x and y parts
scale its rows by kx and ky, the z part its columns by kz), the gradient is
the product X G, (m, 6C), reduced against Y once for each axis.
``reciprocal_energy`` is a ``torch.autograd.Function``: its forward builds
X and Y once, takes both products and keeps the gradient; its backward is
that gradient times the incoming one.  Nothing is recomputed and no graph
is built.  Gradients flow to the positions only (the engine differentiates
nothing else); ``reciprocal_energy_reference`` is the same energy under
autograd, the twin the tests hold the closed form against.

Both products run in full float32: TF32 would cost digits here, so callers
on CUDA keep ``torch.backends.cuda.matmul.allow_tf32`` False (``Context``
sets it).  Where X would not fit in ``FREE_SHARE`` of the free memory,
``chunk_rows`` gives an atom chunk, fixed once from shapes when the
evaluator is built: one pass over the chunks accumulates X^T Y, a second
rebuilds each chunk's phases for its gradient rows.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import trace
from ..units import ONE_4PI_EPS0, PI

# share of the free device (or host) memory that the (m, 2AB) phase block
# may take; with its temporaries the route holds about three times as much
FREE_SHARE = 0.1


def ewald_parameters(r_cutoff: float, tolerance: float = 5e-4,
                     box=None) -> tuple:
    """beta and per-axis kmax from the Ewald error-tolerance formulas used by
    OpenMM (NonbondedForceImpl::calcEwaldParameters)."""
    beta = math.sqrt(-math.log(2.0 * tolerance)) / r_cutoff
    kmax = (0, 0, 0)
    if box is not None:
        box = np.asarray(box, np.float64)

        def find_k(L):
            for k in range(1, 1000):
                err = k * math.sqrt(L * beta) / 20.0 * math.exp(
                    -((PI * k / (L * beta)) ** 2))
                if err < tolerance:
                    return k
            return 1000

        kmax = tuple(int(find_k(L)) for L in box)
    return beta, kmax


def phase_block_bytes(n: int, kmax) -> int:
    """Bytes of the float32 (n, 2AB) phase block X of ``n`` atoms."""
    return n * 2 * (2 * kmax[0] + 1) * (2 * kmax[1] + 1) * 4


def chunk_rows(n: int, kmax, free: float) -> int:
    """The route's atom chunk for ``n`` atoms: 0 (one contraction) where
    their phase block fits in ``FREE_SHARE`` of ``free`` bytes, else the
    most rows, a multiple of 256 and at least 256, whose block does."""
    budget = FREE_SHARE * free
    if phase_block_bytes(n, kmax) <= budget:
        return 0
    rows = int(budget // phase_block_bytes(1, kmax)) // 256 * 256
    return max(rows, 256)


def free_bytes(device) -> int:
    """Free memory of ``device``: the card's, or the host's for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _half_space_weights(kmax, device, dtype=torch.float32):
    """(A,B,C) weight factors of the kz >= 0 half space: x2 everywhere except
    that the kz = 0 plane keeps only its canonical half, (ky > 0) |
    (ky == 0 & kx > 0).  Built on the device: no host copy per call."""
    nx = torch.arange(-kmax[0], kmax[0] + 1, device=device)
    ny = torch.arange(-kmax[1], kmax[1] + 1, device=device)
    plane_half = (ny[None, :] > 0) | ((ny[None, :] == 0) & (nx[:, None] > 0))
    wfac = torch.full((nx.shape[0], ny.shape[0], kmax[2] + 1), 2.0,
                      dtype=dtype, device=device)
    wfac[:, :, 0] = torch.where(plane_half, 2.0, 0.0)
    return wfac


def _k_tables(box, beta, kmax, dtype, dev):
    """kx (A,), ky (B,), kz (C,), the weights w (AB, C) and
    pref = C/(2V) * 4 pi, in ``dtype``."""
    f = dict(dtype=dtype, device=dev)
    two_pi = 2.0 * PI
    kx = two_pi * torch.arange(-kmax[0], kmax[0] + 1, **f) / box[0]
    ky = two_pi * torch.arange(-kmax[1], kmax[1] + 1, **f) / box[1]
    kz = two_pi * torch.arange(0, kmax[2] + 1, **f) / box[2]
    k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kz[None, None, :] ** 2)
    mask = k2 > 1e-10
    k2s = torch.where(mask, k2, torch.ones_like(k2))
    w = torch.where(mask, torch.exp(-k2s / (4.0 * beta * beta)) / k2s,
                    torch.zeros_like(k2))
    w = w * _half_space_weights(kmax, dev, dtype)
    vol = box[0] * box[1] * box[2]
    pref = ONE_4PI_EPS0 * 2.0 * PI / vol
    return kx, ky, kz, w.reshape(-1, kz.shape[0]), pref


def _phases(p, q, kx, ky, kz):
    """(m, 3) positions + (m,) charges -> X (m, 2AB), the charge-weighted
    cos and sin of kx x + ky y, and Y (m, 2C), the cos and sin of kz z."""
    A, B = kx.shape[0], ky.shape[0]
    tx = p[:, 0:1] * kx[None, :]
    ty = p[:, 1:2] * ky[None, :]
    tz = p[:, 2:3] * kz[None, :]
    cx, sx = torch.cos(tx), torch.sin(tx)                     # (m,A)
    cy, sy = torch.cos(ty), torch.sin(ty)                     # (m,B)
    qc = q[:, None, None]
    re = qc * (cx[:, :, None] * cy[:, None, :]
               - sx[:, :, None] * sy[:, None, :])              # (m,A,B)
    im = qc * (cx[:, :, None] * sy[:, None, :]
               + sx[:, :, None] * cy[:, None, :])
    X = torch.cat([re.reshape(-1, A * B), im.reshape(-1, A * B)], dim=1)
    Y = torch.cat([torch.cos(tz), torch.sin(tz)], dim=1)
    return X, Y


def _check_mirror(mirror, n):
    img0, par0, cnt, _ = mirror
    if par0 + cnt != img0 or img0 + cnt != n:
        raise ValueError(
            f"mirror {mirror}: the images must be the trailing block "
            f"and their parents the block just before it ({n} atoms)")


def _images(m_liq, kz, zm):
    """The images' (2AB, 2C) block from their parents' block ``m_liq``:
    rotated per kz column (cos(kz z') = c2m cz + s2m sz, sin(kz z') =
    s2m cz - c2m sz, c2m = cos(2 kz zm), s2m = sin(2 kz zm)) and negated."""
    C = kz.shape[0]
    c2m = torch.cos(2.0 * kz * zm)
    s2m = torch.sin(2.0 * kz * zm)
    mc, ms = m_liq[:, :C], m_liq[:, C:]
    return -torch.cat([mc * c2m + ms * s2m, mc * s2m - ms * c2m], dim=1)


def _structure(M, C):
    """S_re, S_im (AB, C) of the (2AB, 2C) block."""
    ab = M.shape[0] // 2
    return M[:ab, :C] - M[ab:, C:], M[:ab, C:] + M[ab:, :C]


def _closed_form(pos, box, charges, beta, kmax, chunk, mirror, want_grad):
    """(energy, gradient or None) of the route, with no graph: X and Y once
    (or once a chunk in each of two passes), M = X^T Y, then the gradient
    rows of the real atoms as the reduction of X G against Y."""
    dev, dt = pos.device, pos.dtype
    kx, ky, kz, w, pref = _k_tables(box, beta, kmax, dt, dev)
    C = kz.shape[0]
    q = charges.to(dt)
    n = pos.shape[0]
    if mirror is None:
        real, cuts = n, [(0, n)]
    else:
        _check_mirror(mirror, n)
        real, par0 = mirror[0], mirror[1]
        cuts = [(0, par0), (par0, real)]
    chunked = 0 < chunk < real
    reciprocal_energy.chunked_calls += int(chunked)
    if chunked:
        blocks = []
        for lo, hi in cuts:
            M = torch.zeros((w.shape[0] * 2, 2 * C), dtype=dt, device=dev)
            for s in range(lo, hi, chunk):
                e = min(s + chunk, hi)
                Xc, Yc = _phases(pos[s:e], q[s:e], kx, ky, kz)
                M = M + Xc.t() @ Yc
            blocks.append(M)
    else:
        X, Y = _phases(pos[:real], q[:real], kx, ky, kz)
        blocks = [X[lo:hi].t() @ Y[lo:hi] for lo, hi in cuts]
    if mirror is None:
        M = blocks[0]
    else:
        M = blocks[0] + blocks[1] + _images(blocks[1], kz, mirror[3])
    s_re, s_im = _structure(M, C)
    energy = pref * torch.sum(w * (s_re * s_re + s_im * s_im))
    if not want_grad:
        return energy, None
    # X G1 reduced against Y is sum_k (P_k cos k.r - Q_k sin k.r) q_j, with
    # P = 2 pref w S_im, Q = 2 pref w S_re: rows (cos, sin of kx x + ky y),
    # columns (cos, sin of kz z)
    w2 = 2.0 * pref * w
    P, Q = w2 * s_im, w2 * s_re
    G1 = torch.cat([torch.cat([P, -Q], 1), -torch.cat([Q, P], 1)], 0)
    A, B = kx.shape[0], ky.shape[0]
    rx = kx[:, None].expand(A, B).reshape(-1).repeat(2)[:, None]
    ry = ky[None, :].expand(A, B).reshape(-1).repeat(2)[:, None]
    G = torch.cat([G1 * rx, G1 * ry, G1 * kz.repeat(2)], dim=1)  # (2AB,6C)

    def rows(X, Y):
        U = (X @ G).view(-1, 3, 2 * C)
        return torch.sum(U * Y[:, None, :], dim=2)

    if not chunked:
        g = rows(X, Y)
        if real == n:
            return energy, g
        return energy, torch.cat([g, g.new_zeros((n - real, 3))])
    grad = torch.zeros_like(pos)
    for s in range(0, real, chunk):
        e = min(s + chunk, real)
        grad[s:e] = rows(*_phases(pos[s:e], q[s:e], kx, ky, kz))
    return energy, grad


def _route(pos, box, charges, beta, kmax, chunk, mirror, want_grad):
    """``_closed_form``, inside the ``recip.mirror`` span on the mirror
    layout."""
    args = (pos, box, charges, beta, kmax, chunk, mirror, want_grad)
    if mirror is None:
        return _closed_form(*args)
    with trace.span("recip.mirror"):
        return _closed_form(*args)


class _ClosedForm(torch.autograd.Function):
    """The energy, with the position gradient computed in the forward and
    kept; the backward scales it by the incoming gradient."""

    @staticmethod
    def forward(ctx, pos, box, charges, beta, kmax, chunk, mirror):
        energy, grad = _route(pos, box, charges, beta, kmax, chunk, mirror,
                              True)
        ctx.save_for_backward(grad)
        return energy

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None, None, None, None, None, None


def reciprocal_energy(pos, box, charges, beta, kmax, chunk: int = 0,
                      mirror=None):
    """Exact k-space Ewald energy; ``torch.autograd`` with respect to
    ``pos`` returns the closed-form gradient computed beside it (the box
    and the charges get none).  Counts every call in
    ``reciprocal_energy.calls`` and those that took chunks in
    ``reciprocal_energy.chunked_calls``.

    ``chunk`` > 0 below the number of atoms in the sum takes them in chunks
    of that many (``chunk_rows``: a phase block too large for memory); with
    ``mirror`` the two real-atom subsets are chunked each on its own for the
    structure factor.

    ``mirror`` = (img0, par0, count, mirror_z) declares the constant-voltage
    image layout: atoms [img0, img0 + count) are the trailing block and
    mirror the parents [par0, par0 + count) that end where it begins, with
    q_img = -q_parent, x/y copied and z -> 2 mirror_z - z.  The images'
    (2AB, 2C) block is then the parents' one rotated per kz column and
    negated, so only the real atoms' phases are built.  The gradient takes
    the full S, images included, and gives each real atom the partial
    derivative at fixed images (image positions are variables the
    integrator syncs), as in the explicit 2N evaluation; the image rows of
    the gradient are exactly 0.  Any other layout raises ValueError: the
    JAX version would drop the atoms between the parents and the images.
    """
    reciprocal_energy.calls += 1
    charges = torch.as_tensor(charges, device=pos.device)
    kmax = tuple(int(k) for k in kmax)
    mirror = None if mirror is None else tuple(mirror)
    if torch.is_grad_enabled() and pos.requires_grad:
        return _ClosedForm.apply(pos, box, charges, beta, kmax, int(chunk),
                                 mirror)
    with torch.no_grad():
        return _route(pos, box, charges, beta, kmax, int(chunk), mirror,
                      False)[0]


reciprocal_energy.calls = 0
reciprocal_energy.chunked_calls = 0


def reciprocal_energy_reference(pos, box, charges, beta, kmax, mirror=None):
    """The same energy as one contraction differentiated by autograd: the
    route's form before its closed-form gradient, kept as the twin that
    tests and the card script hold ``reciprocal_energy`` against.  Computed
    in the dtype of ``pos``; with ``mirror`` the images' block comes from
    the parents' detached, so a parent's gradient is the partial derivative
    at fixed images and the image rows are exactly 0."""
    dev, dt = pos.device, pos.dtype
    kx, ky, kz, w, pref = _k_tables(box, beta, kmax, dt, dev)
    C = kz.shape[0]
    q = torch.as_tensor(charges, device=dev).to(dt)
    n = pos.shape[0]
    if mirror is None:
        X, Y = _phases(pos, q, kx, ky, kz)
        M = X.t() @ Y
    else:
        _check_mirror(mirror, n)
        img0, par0 = mirror[0], mirror[1]
        Xr, Yr = _phases(pos[:par0], q[:par0], kx, ky, kz)
        Xl, Yl = _phases(pos[par0:img0], q[par0:img0], kx, ky, kz)
        m_liq = Xl.t() @ Yl
        M = Xr.t() @ Yr + m_liq + _images(m_liq.detach(), kz, mirror[3])
    s_re, s_im = _structure(M, C)
    return pref * torch.sum(w * (s_re * s_re + s_im * s_im))
