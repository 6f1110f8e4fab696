"""Reciprocal-space Ewald sum as one matrix product (counterpart of
``openmm_velocityverlet_tpu/ops/ewald.py``).

    E = C/(2V) * sum_{k != 0, |k|<=kc} (4 pi / k^2) exp(-k^2/(4 beta^2)) |S(k)|^2
    S(k) = sum_i q_i exp(i k . r_i)

The structure factor of the kz >= 0 half space is the (2AB, n) x (n, 2C)
contraction of the position phases, one ``torch.matmul``; the force is
``torch.autograd.grad`` of the energy.  The contraction runs in full float32:
TF32 would cost digits here, so callers on CUDA keep
``torch.backends.cuda.matmul.allow_tf32`` False (``Context`` sets it).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..units import ONE_4PI_EPS0, PI


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


def _half_space_weights(kmax, device):
    """(A,B,C) weight factors of the kz >= 0 half space: x2 everywhere except
    that the kz = 0 plane keeps only its canonical half, (ky > 0) |
    (ky == 0 & kx > 0).  Built on the device: no host copy per call."""
    nx = torch.arange(-kmax[0], kmax[0] + 1, device=device)
    ny = torch.arange(-kmax[1], kmax[1] + 1, device=device)
    plane_half = (ny[None, :] > 0) | ((ny[None, :] == 0) & (nx[:, None] > 0))
    wfac = torch.full((nx.shape[0], ny.shape[0], kmax[2] + 1), 2.0,
                      dtype=torch.float32, device=device)
    wfac[:, :, 0] = torch.where(plane_half, 2.0, 0.0)
    return wfac


def reciprocal_energy(pos, box, charges, beta, kmax, chunk: int = 0,
                      chunk_min_bytes: float = 40e6, mirror=None):
    """Exact k-space Ewald energy, differentiable in ``pos``.

    ``chunk`` > 0 with more than 2*chunk atoms and a phase block above
    ``chunk_min_bytes`` accumulates the contraction over atom chunks, each
    under ``torch.utils.checkpoint`` so the (chunk, 2AB) phase block is
    recomputed in the backward pass instead of being kept (the JAX
    version's ``jax.checkpoint`` inside ``lax.scan``).
    """
    if mirror is not None:
        raise NotImplementedError(
            "the image-mirror reciprocal (constant-voltage EDL) is not "
            "ported yet (ROADMAP A11)")
    dev = pos.device
    f32 = dict(dtype=torch.float32, device=dev)
    ax = torch.arange(-kmax[0], kmax[0] + 1, **f32)
    ay = torch.arange(-kmax[1], kmax[1] + 1, **f32)
    az = torch.arange(0, kmax[2] + 1, **f32)
    A, B, C = ax.shape[0], ay.shape[0], az.shape[0]
    two_pi = 2.0 * PI
    kx = two_pi * ax / box[0]
    ky = two_pi * ay / box[1]
    kz = two_pi * az / box[2]
    k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kz[None, None, :] ** 2)
    mask = k2 > 1e-10
    k2s = torch.where(mask, k2, torch.ones_like(k2))
    w = torch.where(mask, torch.exp(-k2s / (4.0 * beta * beta)) / k2s,
                    torch.zeros_like(k2))
    w = w * _half_space_weights(kmax, dev)
    charges = torch.as_tensor(charges, **f32)

    def contraction(p, q):
        """(m, 3) positions + (m,) charges -> their (2AB, 2C) block."""
        tx = p[:, 0:1] * kx[None, :]
        ty = p[:, 1:2] * ky[None, :]
        tz = p[:, 2:3] * kz[None, :]
        cx, sx = torch.cos(tx), torch.sin(tx)                 # (m,A)
        cy, sy = torch.cos(ty), torch.sin(ty)                 # (m,B)
        cz, sz = torch.cos(tz), torch.sin(tz)                 # (m,C)
        qc = q[:, None, None]
        re = qc * (cx[:, :, None] * cy[:, None, :]
                   - sx[:, :, None] * sy[:, None, :])          # (m,A,B)
        im = qc * (cx[:, :, None] * sy[:, None, :]
                   + sx[:, :, None] * cy[:, None, :])
        X = torch.cat([re.reshape(-1, A * B), im.reshape(-1, A * B)],
                      dim=1)                                   # (m,2AB)
        Y = torch.cat([cz, sz], dim=1)                         # (m,2C)
        return torch.matmul(X.t(), Y)                          # (2AB,2C)

    m = pos.shape[0]
    x_bytes = m * 2 * A * B * 4
    if chunk and m > 2 * chunk and x_bytes > chunk_min_bytes:
        M = torch.zeros((2 * A * B, 2 * C), **f32)
        for s in range(0, m, chunk):
            M = M + checkpoint(contraction, pos[s:s + chunk],
                               charges[s:s + chunk], use_reentrant=False)
    else:
        M = contraction(pos, charges)
    rc_, rs_ = M[:A * B, :C], M[:A * B, C:]
    ic_, is_ = M[A * B:, :C], M[A * B:, C:]
    S_re = (rc_ - is_).reshape(A, B, C)
    S_im = (rs_ + ic_).reshape(A, B, C)
    vol = box[0] * box[1] * box[2]
    return (ONE_4PI_EPS0 * 2.0 * PI / vol
            * torch.sum(w * (S_re * S_re + S_im * S_im)))
