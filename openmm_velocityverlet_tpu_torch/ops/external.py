"""Auxiliary / external forces, the ommhelper ``force.py`` toolbox
(counterpart of ``openmm_velocityverlet_tpu/ops/external.py``).

Each constructor returns an energy closure ``f(pos, box) -> E`` on tensors
that the ForceEvaluator adds to the potential.  Where the closure carries
an ``analytic_force(pos, box) -> (N,3)`` attribute, the evaluator adds
that force instead of differentiating the energy; the others take their
force from ``torch.autograd``.  Index and parameter tables are placed on
``pos.device`` at the first call there.  Functional forms and conventions
follow the reference's examples/ommhelper/force.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..units import ONE_4PI_EPS0, PI
from ..utils.pbc import minimum_image


def _per_device(build):
    """``get(device)``: the dict ``build(device)`` returns, built once per
    device."""
    cache = {}

    def get(dev):
        t = cache.get(dev)
        if t is None:
            t = cache[dev] = build(dev)
        return t
    return get


def _f32(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _idx(a, dev):
    return torch.as_tensor(np.asarray(a, np.int64), device=dev)


def spring_self(particles, ref_positions, strength):
    """Harmonic position restraints (force.py:51-91):
    E = kx dx^2 + ky dy^2 + kz dz^2 with minimum-image deltas (the reference
    uses ``periodicdistance`` per axis)."""
    particles = np.asarray(particles, np.int64)
    ref_all = np.asarray(ref_positions)
    n_ref = ref_all.shape[0]
    mask = np.zeros(n_ref, np.float32)
    mask[particles] = 1.0
    ref_full = np.zeros((n_ref, 3), np.float32)
    ref_full[particles] = ref_all[particles].astype(np.float32)
    tables = _per_device(lambda dev: dict(
        idx=_idx(particles, dev), ref=_f32(ref_full[particles], dev),
        k=_f32(strength, dev), mask=_f32(mask, dev)[:, None],
        ref_full=_f32(ref_full, dev)))

    def energy(pos, box):
        t = tables(pos.device)
        d = minimum_image(pos[t["idx"]] - t["ref"], box)
        return torch.sum(t["k"][None, :] * d * d)

    def analytic_force(pos, box):
        t = tables(pos.device)
        d = minimum_image(pos - t["ref_full"], box)
        return (-2.0 * t["k"][None, :]) * d * t["mask"]

    energy.analytic_force = analytic_force
    return energy


def wall_power(particles, axis, bound, k, cutoff, power=2):
    """Power wall (force.py:94-141): E = k ((bound_lo + cutoff - x) /
    cutoff)^p below, symmetric above.  No PBC (as the reference)."""
    tables = _per_device(lambda dev: dict(idx=_idx(particles, dev)))
    lo, hi = bound
    lo0, hi0 = lo + cutoff, hi - cutoff

    def energy(pos, box):
        x = pos[tables(pos.device)["idx"], axis]
        rmin = torch.clamp((lo0 - x) / cutoff, min=0.0)
        rmax = torch.clamp((x - hi0) / cutoff, min=0.0)
        return torch.sum(k * (rmin ** power + rmax ** power))

    return energy


def wall_lj126(particles, axis, bound, epsilon, sigma):
    """LJ-12-6 wall (force.py:144-191): E = 4 eps (r^-12 - r^-6 + 1/4) inside
    the repulsive zone, with r = (x - bound) / sigma."""
    particles = np.asarray(particles, np.int64)
    lo, hi = bound
    cut = sigma * 2.0 ** (1.0 / 6.0)
    lo0, hi0 = lo + cut, hi - cut
    unit = np.zeros(3, np.float32)
    unit[axis] = 1.0
    tables = _per_device(lambda dev: dict(idx=_idx(particles, dev),
                                          unit=_f32(unit, dev)))
    masks = {}

    def elj(r):
        r6 = r ** 6
        return 4.0 * epsilon * (r6 * r6 - r6 + 0.25)

    def energy(pos, box):
        x = pos[tables(pos.device)["idx"], axis]
        rlo = sigma / torch.clamp(x - lo, min=1e-6)
        rhi = sigma / torch.clamp(hi - x, min=1e-6)
        zero = torch.zeros_like(x)
        e = (torch.where(x < lo0, elj(rlo), zero)
             + torch.where(x > hi0, elj(rhi), zero))
        return torch.sum(e)

    def flj(r, dist):
        r = torch.clamp(r, max=1e3)          # keep r^12 finite in float32
        r6 = r ** 6
        # F = 4 eps (12 r^12 - 6 r^6) / dist, pushing off the wall
        return 4.0 * epsilon * (12.0 * r6 * r6 - 6.0 * r6) / dist

    def analytic_force(pos, box):
        n, dev = pos.shape[0], pos.device
        inz = masks.get((dev, n))
        if inz is None:
            m = np.zeros(n, bool)
            m[particles] = True
            inz = masks[(dev, n)] = torch.as_tensor(m, device=dev)
        x = pos[:, axis]
        dlo = torch.clamp(x - lo, min=1e-6)
        dhi = torch.clamp(hi - x, min=1e-6)
        zero = torch.zeros_like(x)
        fx = (torch.where(inz & (x < lo0), flj(sigma / dlo, dlo), zero)
              - torch.where(inz & (x > hi0), flj(sigma / dhi, dhi), zero))
        return fx[:, None] * tables(dev)["unit"]

    energy.analytic_force = analytic_force
    return energy


def electric_field_force(particles, charges, strength_v_per_nm):
    """CustomExternalForce E-field variant (force.py:194-227):
    E = conv (Ex q x + Ey q y + Ez q z), conv = 96.4853... kJ/mol per e V."""
    particles = np.asarray(particles, np.int64)
    q = np.asarray(charges)[particles]
    conv = 96.4853400990037
    tables = _per_device(lambda dev: dict(
        idx=_idx(particles, dev), q=_f32(q, dev),
        ef=_f32(strength_v_per_nm, dev)))

    def energy(pos, box):
        t = tables(pos.device)
        return conv * torch.sum(
            t["q"] * torch.sum(t["ef"][None, :] * pos[t["idx"]], -1))

    return energy


def slab_correction(charges):
    """Yeh-Berkowitz slab correction (force.py:6-48):
    E = 2 pi / V C muz^2, muz = sum q_i z_i."""
    tables = _per_device(lambda dev: dict(q=_f32(charges, dev)))

    def energy(pos, box):
        vol = box[0] * box[1] * box[2]
        muz = torch.sum(tables(pos.device)["q"] * pos[:, 2])
        return 2.0 * PI / vol * ONE_4PI_EPS0 * muz * muz

    return energy


def restrain_particle_number(particles, axis, bound, sigma, target, k,
                             weights=None):
    """Gaussian-smoothed particle-count restraint (force.py:285-348)."""
    particles = np.asarray(particles, np.int64)
    w = (np.ones(particles.shape, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    tables = _per_device(lambda dev: dict(idx=_idx(particles, dev),
                                          w=_f32(w, dev)))
    lo, hi = bound
    s = sigma * np.sqrt(2.0)

    def energy(pos, box):
        t = tables(pos.device)
        x = pos[t["idx"], axis]
        t_lo = torch.erf((lo - x) / s) if lo is not None else -1.0
        t_hi = torch.erf((hi - x) / s) if hi is not None else 1.0
        number = torch.sum(0.5 * (t_hi - t_lo) * t["w"])
        return 0.5 * k * (number - target) ** 2

    return energy
