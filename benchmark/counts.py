"""The yardstick of the per-layer rates: the card's published peaks and the
work a step's physics needs, counted from the System's shapes and the
cell's positions by the cheapest known form of each term, so that it reads
the same whatever implements the term.

* Pairs: every pair i < j within the cutoff under the minimum image;
  ``PAIR_OPS`` float32 operations each.  Massless virtual sites count:
  their forces move to their parents.
* The reciprocal route: its module's count (``ops`` of
  ``benchmark/routes/<recip>.py``), beside its lattice or grid.
* The bonded terms, constraints and thermostat are O(N) and left out.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# float32 operations of one pair in the force-only specialization of the
# pair kernels (rsqrtf, rintf and min/max count one each): minimum image
# 12, r^2 5, qq 1, LJ 14, erfc polynomial 20, Coulomb 5, masks and sums 13
PAIR_OPS = 70


def cutoff_pairs(pos, box, r_cutoff, block=1024):
    """Pairs i < j within the cutoff under the minimum image."""
    n = pos.shape[0]
    box = box.reshape(1, 1, 3)
    j = torch.arange(n, device=pos.device)[None, :]
    total = 0
    for s in range(0, n, block):
        d = pos[s:s + block, None, :] - pos[None, :, :]
        d = d - box * torch.round(d / box)
        r2 = torch.sum(d * d, -1)
        i = torch.arange(s, min(s + block, n), device=pos.device)[:, None]
        hit = (r2 < r_cutoff * r_cutoff) & (j > i)
        total += int(hit.sum())
    return total


def b1_bytes(n_atoms):
    """Bytes a pair sweep must move at least: positions, charges and types
    read once (float32 x 3, float32, int32), forces written once."""
    return n_atoms * (12 + 4 + 4 + 12)


def bound_s(ops, n_bytes):
    """The least time the card could take: the larger of operations over
    the FP32 peak and bytes over the memory rate."""
    return max(ops / PEAK_FP32, n_bytes / PEAK_BYTES)


def step_work(system, pos, box, recip_ops):
    """(pair count, float32 operations) a step's physics needs at ``pos``:
    the pairs, and the reciprocal route's ``recip_ops``."""
    pairs = cutoff_pairs(pos, box, float(system.r_cutoff))
    return pairs, pairs * PAIR_OPS + recip_ops
