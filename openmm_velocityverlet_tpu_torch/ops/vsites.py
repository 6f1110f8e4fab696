"""Virtual sites (LocalCoordinatesSite lone pairs; counterpart of
``openmm_velocityverlet_tpu/ops/vsites.py``).

    origin = sum wo_k r_k ;  xdir = sum wx_k r_k ;  ydir = sum wy_k r_k
    x = normalize(xdir); z = normalize(x cross ydir); y = z cross x
    r_site = origin + px*x + py*y + pz*z

Force redistribution is the transpose Jacobian of the placement, taken by
``torch.autograd.grad`` where the JAX version used ``jax.vjp``.  Index
tables are int64 tensors on the device of ``pos``.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def compute_vsites(pos, vsite_index, vsite_parents, origin_w, x_w, y_w,
                   local):
    """Positions with every virtual-site row replaced by its parent-frame
    placement.  Differentiable."""
    if vsite_index.shape[0] == 0:
        return pos
    p = pos[vsite_parents]                             # (V,3parents,3)
    origin = torch.einsum("vp,vpx->vx", origin_w, p)
    xdir = torch.einsum("vp,vpx->vx", x_w, p)
    ydir = torch.einsum("vp,vpx->vx", y_w, p)
    xhat = xdir / torch.sqrt(torch.sum(xdir * xdir, -1, keepdim=True) + _EPS)
    z = torch.linalg.cross(xhat, ydir)
    zhat = z / torch.sqrt(torch.sum(z * z, -1, keepdim=True) + _EPS)
    yhat = torch.linalg.cross(zhat, xhat)
    site = (origin + local[:, 0:1] * xhat + local[:, 1:2] * yhat
            + local[:, 2:3] * zhat)
    return pos.index_put((vsite_index,), site)


def redistribute_forces(pos, forces, vsite_index, vsite_parents, origin_w,
                        x_w, y_w, local):
    """Move forces acting on virtual sites onto their parents (J^T f)."""
    if vsite_index.shape[0] == 0:
        return forces
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        placed = compute_vsites(p, vsite_index, vsite_parents, origin_w,
                                x_w, y_w, local)
        (out,) = torch.autograd.grad(placed, p, grad_outputs=forces)
    return out
