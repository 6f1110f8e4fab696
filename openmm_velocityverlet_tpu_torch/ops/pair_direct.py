"""``direct_space_tiled``: the tiled direct-space sweep with every branch of
the JAX ``openmm_velocityverlet_tpu/ops/pallas_pair.py:direct_space_pallas``
(the JAX package's stand-in for ``direct_space_dense``).  ``ForceEvaluator``
holds its own sweep object (``forces.pair_sweep``) and does not call this;
it is the public entry to the rectangular sweep (kernel B3) and runs the
others through their modules."""
from __future__ import annotations

import numpy as np
import torch

from .pair_plist import (direct_space_plist, padded_statics,
                         residual_adjustment)
from .pair_rect import run_rect
from .pair_tri import band_statics, direct_space_band, padded_size


def direct_space_tiled(pos, box, charges, tables, beta, r_cutoff,
                       tm: int = 256, tn: int = 512, symmetric: bool = True,
                       ts: int = 512, band_w: int = 0,
                       want_energy: bool = True, cache=None,
                       with_flag: bool = False, mode: str = "band",
                       plist_cap: int = 0, skin: float = 0.1,
                       plist_sort: str = "morton", r_switch: float = 0.0,
                       strict: bool = True, nowrap=(False, False, False)):
    """The counterpart of the JAX ``direct_space_pallas`` (its signature
    less ``interpret``).  Returns (e_lj, e_coul, e_corr, e14_coul, e14_lj,
    forces), plus the coverage flag when ``with_flag``.

    * ``symmetric=False``: the full rectangular sweep (kernel B3) on the
      unsorted layout padded to a whole number of ``max(tm, tn)`` atoms;
      each pair is counted from both sides, so the energies are half the
      row sums.  Kernel-folded 1-4 exceptions need the symmetric sweep.
    * ``mode="plist"`` with ``plist_cap > 0``: the tile-pair-list sweep
      (kernel B1, ``pair_plist.direct_space_plist``).
    * otherwise the upper-triangle sweep of kernel B2
      (``pair_tri.direct_space_band``): the z band when ``band_w`` makes it
      eligible, else the unsorted band + far sweep (``run_tri`` at
      ``band_w=0``).

    ``strict`` (the JAX default True) takes the exhaustive full sweep when
    the coverage check of a sorted cache trips; the flag then comes back as
    a Python bool.  ``charges`` may be a numpy array or a tensor."""
    dev = pos.device
    n = pos.shape[0]
    box = torch.as_tensor(box, dtype=torch.float32, device=dev).reshape(3)
    # the padded static columns are built on the host from numpy charges;
    # the residual adjustment reads the charges on the device
    q_np = (charges.detach().cpu().numpy()
            if isinstance(charges, torch.Tensor) else np.asarray(charges))
    q_np = q_np.astype(np.float32)
    charges = torch.as_tensor(q_np, device=dev)
    if symmetric and mode == "plist" and plist_cap > 0:
        out = direct_space_plist(
            pos, box, charges, tables, beta, r_cutoff, ts,
            want_energy=want_energy, cache=cache, plist_cap=plist_cap,
            skin=skin, plist_sort=plist_sort, r_switch=r_switch,
            strict=strict, nowrap=nowrap,
            statics=padded_statics(q_np, tables, ts, dev))
    elif symmetric:
        out = direct_space_band(
            pos, box, charges, tables, beta, r_cutoff, ts, band_w,
            want_energy=want_energy, cache=cache, r_switch=r_switch,
            strict=strict, statics=band_statics(
                q_np, tables, padded_size(n, ts), dev))
    else:
        if tables.get("has_exc14", False):
            raise NotImplementedError(
                "kernel-handled 1-4 exceptions require the symmetric sweep")
        blk = max(tm, tn)
        fout = run_rect(pos, box, q_np, tables, beta=beta,
                        r_cutoff=r_cutoff, blk=blk, r_switch=r_switch,
                        statics=band_statics(q_np, tables,
                                             padded_size(n, blk), dev))
        e_lj, e_coul, e_corr = (0.5 * torch.sum(fout[:, c])
                                for c in (3, 4, 5))
        e_lj, e_coul, e_corr, forces = residual_adjustment(
            pos, box, charges, tables, beta, r_cutoff, e_lj, e_coul, e_corr,
            fout[:n, :3], r_switch=r_switch)
        z = torch.zeros((), dtype=torch.float32, device=dev)
        out = (e_lj, e_coul, e_corr, z, z, forces,
               torch.zeros((), dtype=torch.bool, device=dev))
    return out if with_flag else out[:6]
