"""The tile-pair-list ("plist") direct-space sweep and kernel B1
(counterpart of the plist half of ``openmm_velocityverlet_tpu/ops/
pallas_pair.py``: ``_pfit``, ``PairCache``, ``make_pair_cache``,
``plist_coverage_bad``, the host-numpy sizing helpers,
``residual_adjustment`` and the plist branch of ``direct_space_pallas``).

Atoms are sorted in 3-D Morton order (or by wrapped z), cut into tiles of
``ts`` atoms, and only tile pairs whose circular AABBs come within
cutoff + skin are listed.  ``plist_pair`` runs the list: on a CUDA tensor it
launches kernel B1 (``csrc/plist_pair.cu``); on a CPU tensor it takes the
plain torch version ``plist_pair_reference``, which computes the same
``(rows, colacc)`` from the same inputs.

Building and running the list make no host synchronisation: the list keeps
its fixed capacity (the JAX ``jnp.nonzero(size=cap)``), filled by a
cumulative-sum rank instead of ``torch.nonzero``.
"""
from __future__ import annotations

import ctypes
import functools
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..units import ONE_4PI_EPS0
from .allpairs import residual_pair_terms

_SQRT_PI = 1.7724538509055159
MAX_EXCL_OFFSET = 31
# Coulomb force cap of the plist kernel, 1/0.045^3 rounded to float32 (the
# allpairs cap contract)
_CAP3 = float(np.float32(1.0 / 0.045 ** 3))

# Safety slack (nm) for the first-atom-frame minimum image on "nowrap"
# axes: the tile-extent budgets subtract this on top of rc_cand, covering
# extent drift between the build-time check and the per-step re-check.
NOWRAP_SLACK = 0.2

# pairs per batch of plist_pair_reference: bounds its (E, ts, ts)
# temporaries to a few hundred MB on a card
_REF_BATCH_PAIRS = 1 << 22


def slice_entries(ts: int) -> int:
    """Entries of a row tile that one block of kernel B1 takes: 16 at
    ts = 32, 4 at 64, one from 96 on (a block then is one tile pair)."""
    return max(1, 16 // (ts // 32) ** 2)


@functools.lru_cache(maxsize=8)
def _pfit(beta: float, r_cutoff: float, deg: int = 10):
    """Chebyshev fit of P(u) on u in [0, (1.05 beta rc)^2], where the Ewald
    direct/correction forces take the div/exp/erfc-free forms

        f_c = qq (1/r^3 + beta^3 P(u)),   f_x = qq beta^3 P(u),   u = beta^2 r^2

    via G(x) = erfc(x) + (2/sqrt(pi)) x exp(-x^2) = 1 + x^3 P(x^2).  The
    small-u branch uses the series of P (the direct formula cancels
    catastrophically below u ~ 0.25).  f32 Horner error ~5e-6 absolute on a
    P range of -0.75..-0.05 — far below pairwise force noise.  Valid for
    every in-cutoff pair and every excluded (intramolecular) pair; beyond
    1.05 rc the result is masked (direct) or physically unreachable
    (exclusions span < 0.7 nm).

    A plain-cutoff system (beta = 0) has no Ewald term: the scaled
    coefficients c_k beta^(2k+3) all vanish, the fit interval collapses to
    u = 0, and the coefficients returned are zero."""
    import math as _m
    if beta == 0:
        return (0.0,) * (deg + 1)
    umax = (1.05 * beta * r_cutoff) ** 2
    u = np.linspace(0.0, umax, 40001)
    x = np.sqrt(u)
    big = u > 0.25
    with np.errstate(divide="ignore", invalid="ignore"):
        try:
            from scipy.special import erfc as _erfc
            gm1 = _erfc(x) + 2.0 / _SQRT_PI * x * np.exp(-u) - 1.0
        except ImportError:
            _e = np.vectorize(_m.erfc)
            gm1 = _e(x) + 2.0 / _SQRT_PI * x * np.exp(-u) - 1.0
        p_big = np.where(big, gm1 / np.maximum(x * u, 1e-300), 0.0)
    acc = np.zeros_like(u)
    term = np.ones_like(u)
    for n_ in range(30):
        acc = acc + term / (2 * n_ + 3)
        term = term * (-u) / (n_ + 1)
    p_small = -(4.0 / _SQRT_PI) * acc
    pex = np.where(big, p_big, p_small)
    c = np.polynomial.chebyshev.Chebyshev.fit(
        u, pex, deg, domain=[0, umax]).convert(
        kind=np.polynomial.Polynomial).coef
    return tuple(float(v) for v in c)


@functools.lru_cache(maxsize=8)
def _pfit_scaled(beta: float, r_cutoff: float, deg: int = 10):
    """_pfit coefficients with beta folded in: the kernels evaluate the
    Horner chain directly in r^2 (c_k' = c_k beta^(2k+3)), saving the
    per-pair u = beta^2 r^2 and w *= beta^3 multiplies."""
    c = _pfit(beta, r_cutoff, deg)
    return tuple(float(ck) * float(beta) ** (2 * k + 3)
                 for k, ck in enumerate(c))


class PairCache(NamedTuple):
    """The sorted layout and pair list, rebuilt every few dozen steps;
    staleness is safe because the per-step coverage check runs against
    current positions.  Per-atom fields are in sorted order, n_pad long."""
    perm: torch.Tensor       # (n_pad,) int64 sorted slot -> original index
    invperm: torch.Tensor    # (n_pad,) int64
    q: torch.Tensor          # (n_pad,) f32 sorted charges
    bits: torch.Tensor       # (n_pad,) i32 sorted exclusion masks
    oid: torch.Tensor        # (n_pad,) i32 original indices (perm)
    ljt: torch.Tensor        # (n_pad,) i32 LJ type, -1 on pad atoms
    grp: torch.Tensor        # (n_pad,) i32 interaction group
    # tile-major stacked LJ rows as in the JAX cache: per row tile k the
    # rows [S*k*ts, S*(k+1)*ts) hold [A-rows; B-rows(; G-rows)].  The JAX
    # kernel selects a, b (and the group mask) with one one-hot MXU dot
    # against oh2T; kernel B1 indexes the same rows by the column atom's
    # ljt / grp, its exact index form.
    ab2: torch.Tensor        # (S*n_pad, K) f32
    plist: torch.Tensor      # (cap,) i32 row_tile<<17 | col_tile<<3 | flags
    cand: torch.Tensor       # (T,T) bool AABB-candidate tile pairs
    overflow: torch.Tensor   # () bool: candidates exceeded cap (or the
    #                          nowrap frame budget failed)
    tile_inert: Optional[torch.Tensor]  # (T,) bool, force-path culling
    # per-tile index of kernel B1: entries [row_ptr[t], row_ptr[t+1]) have
    # row tile t (the list is sorted by row tile) and are one block's work;
    # col_idx[col_ptr[t]:col_ptr[t+1]] are the off-diagonal entries with
    # column tile t, ascending, whose column partials the kernel sums
    row_ptr: torch.Tensor    # (T+1,) i32
    col_ptr: torch.Tensor    # (T+1,) i32
    col_idx: torch.Tensor    # (cap,) i32
    # kernel B1's blocks (slice_blocks): row tile and first entry of each
    # block, and the blocks [blk_ptr[t], blk_ptr[t+1]) of row tile t
    blk_tile: torch.Tensor   # (cap // slice + T,) i32, -1 for no block
    blk_e0: torch.Tensor     # (cap // slice + T,) i32
    blk_ptr: torch.Tensor    # (T+1,) i32
    # row-layout LJ rows [A | B] and group rows, sorted: the strict
    # fallback runs kernel B2 on this layout (pair_tri.run_tri)
    ab: torch.Tensor         # (n_pad, 2T) f32
    grows: Optional[torch.Tensor]  # (n_pad, G) f32, None without groups


def _f32_sq(x: float) -> float:
    """x*x evaluated in float32, as a host number (a Python scalar in a
    tensor op avoids the host-to-device copy a tensor would need)."""
    return float(np.float32(x) * np.float32(x))


def _morton_key(pos, box, n_pad):
    """3-D Z-order (Morton) key of wrapped positions, 6 bits per axis;
    padding slots sort to the end."""
    n = pos.shape[0]
    w = pos - box * torch.floor(pos / box)
    cell = torch.clamp((w / box * 64.0).to(torch.int32), 0, 63)
    # bit b of each axis's cell to bit 3b, the three axes at once (the
    # magic-number interleave, exact for cells below 256)
    s = (cell | (cell << 8)) & 0x0300F00F
    s = (s | (s << 4)) & 0x030C30C3
    s = (s | (s << 2)) & 0x09249249
    key = s[:, 0] | (s[:, 1] << 1) | (s[:, 2] << 2)
    return torch.cat([key, torch.full((n_pad - n,), 1 << 20,
                                      dtype=torch.int32, device=pos.device)])


def _tile_intervals(pos_sorted, valid, box, ts):
    """Per-tile circular AABBs along each axis: (cmean, lo, hi, nonempty)
    with shapes (T,3),(T,3),(T,3),(T,).  A tile straddling a periodic
    boundary is measured in two frames (wrapped and half-shifted) and the
    narrower interval wins."""
    n_tiles = pos_sorted.shape[0] // ts
    w = pos_sorted - box * torch.floor(pos_sorted / box)
    w = w.reshape(n_tiles, ts, 3)
    v = valid.reshape(n_tiles, ts, 1)
    half = 0.5 * box
    w2 = w - torch.where(w >= half, box, torch.zeros_like(box))
    lo1 = torch.amin(torch.where(v, w, 1e30), dim=1)
    hi1 = torch.amax(torch.where(v, w, -1e30), dim=1)
    lo2 = torch.amin(torch.where(v, w2, 1e30), dim=1)
    hi2 = torch.amax(torch.where(v, w2, -1e30), dim=1)
    use2 = (hi2 - lo2) < (hi1 - lo1)
    lo_w = torch.where(use2, lo2, lo1)
    hi_w = torch.where(use2, hi2, hi1)
    cmean = 0.5 * (lo_w + hi_w)
    lo = lo_w - cmean
    hi = hi_w - cmean
    nonempty = valid.reshape(n_tiles, ts).any(dim=1)
    zero = torch.zeros_like(lo)
    lo = torch.where(nonempty[:, None], lo, zero)
    hi = torch.where(nonempty[:, None], hi, zero)
    cmean = torch.where(nonempty[:, None], cmean, zero)
    return cmean, lo, hi, nonempty


def _tile_pair_dist2(cmean, lo, hi, box):
    """(T,T) squared distance between per-tile circular AABBs (0 when they
    overlap); intervals wider than half the box overlap on that axis."""
    delta = torch.remainder(cmean[None, :, :] - cmean[:, None, :]
                            + 0.5 * box, box) - 0.5 * box      # (T,T,3) j-i
    gap = torch.where(delta >= 0,
                      delta - hi[:, None, :] + lo[None, :, :],
                      -delta - hi[None, :, :] + lo[:, None, :])
    wide = (hi - lo) > 0.5 * box
    gap = torch.where(wide[:, None, :] | wide[None, :, :],
                      torch.zeros_like(gap), gap)
    gap = torch.clamp(gap, min=0.0)
    return torch.sum(gap * gap, dim=-1)


def padded_statics(charges, tables, ts, device):
    """Original-order per-atom columns padded to a whole number of tiles
    (q, ab = [A-rows, B-rows], bits, grows or None, ljt, grp) and the
    unpadded exclusion masks, on ``device``.  Pad atoms carry zero charge,
    zero LJ rows and type -1.  Build once per system and pass to
    ``make_pair_cache``."""
    if tables.get("has_exc14", False):
        raise NotImplementedError(
            "the tile-pair list does not fold 1-4 exceptions (nor does the "
            "JAX plist sweep); they run in the band sweep, which "
            "ForceEvaluator(fold_exc14=True) selects")
    n = tables["arows"].shape[0]
    pad = -(-n // ts) * ts - n

    def col(a, fill, dtype):
        a = np.asarray(a)
        full = np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)
        return torch.as_tensor(full.astype(dtype), device=device)

    lj_type = np.argmax(tables["onehot"], axis=1)
    groups = tables["grows"] is not None
    return dict(
        excl_bits=torch.as_tensor(tables["excl_bits"].astype(np.int64),
                                  device=device),
        q=col(np.asarray(charges, np.float32), 0.0, np.float32),
        ab=col(np.concatenate([tables["arows"], tables["brows"]], 1), 0.0,
               np.float32),
        bits=col(tables["excl_bits"], 0, np.int32),
        grows=col(tables["grows"], 0.0, np.float32) if groups else None,
        ljt=col(lj_type, -1, np.int32),
        grp=col(np.argmax(tables["gonehot"], axis=1) if groups
                else np.zeros(n, np.int64), 0, np.int32))


def slice_blocks(row_ptr, cap: int, ts: int):
    """Cut each row tile's entries into slices of ``slice_entries(ts)``, one
    block of kernel B1 each: returns (blk_tile, blk_e0, blk_ptr), int32.
    The block count is fixed at ``cap // slice + n_tiles`` (no host
    synchronisation); blocks beyond the slices in use carry tile -1."""
    dev = row_ptr.device
    s = slice_entries(ts)
    n_tiles = row_ptr.shape[0] - 1
    n_blocks = cap // s + n_tiles
    row_ptr = row_ptr.to(torch.int64)
    n_slices = (row_ptr[1:] - row_ptr[:-1] + (s - 1)) // s
    blk_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(n_slices, 0)])
    b = torch.arange(n_blocks, device=dev)
    tile = torch.clamp(torch.searchsorted(blk_ptr, b, right=True) - 1,
                       max=n_tiles - 1)
    used = b < blk_ptr[-1]
    e0 = row_ptr[tile] + (b - blk_ptr[tile]) * s
    i32 = torch.int32
    return (torch.where(used, tile, torch.full_like(tile, -1)).to(i32),
            torch.where(used, e0, torch.zeros_like(e0)).to(i32),
            blk_ptr.to(i32))


def make_pair_cache(pos, box, charges, tables, ts: int, mode: str = "morton",
                    cap: int = 0, rc_cand: float = 0.0, inert=None,
                    nowrap=(False, False, False),
                    statics=None) -> PairCache:
    """Sort atoms spatially, permute the static columns and build the
    AABB-culled tile-pair list of capacity ``cap`` (candidate radius
    ``rc_cand`` = cutoff + refresh skin).  ``mode`` is the sort key:
    "morton" (3-D Z-order) or "z" (wrapped z).  ``perm`` and ``plist`` are
    bit-identical to the JAX ``make_pair_cache``: the sort is stable on the
    same int32 / float32 keys, which is ``lax.sort((keys, iota),
    num_keys=2)``."""
    if cap <= 0:
        raise ValueError("the plist sweep needs a pair-list capacity > 0")
    dev = pos.device
    n = pos.shape[0]
    n_pad = -(-n // ts) * ts
    pad = n_pad - n
    n_tiles = n_pad // ts
    if n_tiles >= (1 << 14):
        raise ValueError("plist packing: too many tiles")
    if statics is None:
        statics = padded_statics(charges, tables, ts, dev)
    box = torch.as_tensor(box, dtype=torch.float32, device=dev).reshape(3)
    pos = pos.to(torch.float32)
    if mode == "morton":
        keys = _morton_key(pos, box, n_pad)
    else:
        lz = box[2]
        zw = pos[:, 2] - lz * torch.floor(pos[:, 2] / lz)
        keys = torch.cat([zw, torch.full((pad,), 1e30, dtype=torch.float32,
                                         device=dev)])
    perm = torch.sort(keys, stable=True).indices
    iota = torch.arange(n_pad, device=dev)
    invperm = torch.empty_like(perm)
    invperm[perm] = iota
    ab = statics["ab"][perm]

    pos_pad = torch.cat([pos, torch.full((pad, 3), 1e6, dtype=torch.float32,
                                         device=dev)])[perm]
    valid = perm < n
    cmean, lo, hi, nonempty = _tile_intervals(pos_pad, valid, box, ts)
    d2 = _tile_pair_dist2(cmean, lo, hi, box)
    pair_ok = nonempty[:, None] & nonempty[None, :]
    cand = (d2 <= _f32_sq(rc_cand)) & pair_ok
    eye = torch.eye(n_tiles, dtype=torch.bool, device=dev)
    cand = cand | (eye & nonempty[:, None])
    tile_inert = None
    if inert is not None:
        # inert-inert tile pairs produce forces only on particles whose
        # forces are discarded; the force path's list culls them
        inert_pad = torch.cat([torch.as_tensor(np.asarray(inert, bool),
                                               device=dev),
                               torch.ones(pad, dtype=torch.bool,
                                          device=dev)])[perm]
        tile_inert = inert_pad.reshape(n_tiles, ts).all(dim=1)
        cand = cand & ~(tile_inert[:, None] & tile_inert[None, :] & ~eye)
    # exclusion tile-pair flags: an excluded pair (o, o+d), d in 1..31, is
    # recorded in the bits of o; flag its tile pair (exact set, both ways)
    t_of = (invperm[:n] // ts)
    bits_o = statics["excl_bits"]
    d = torch.arange(1, MAX_EXCL_OFFSET + 1, device=dev)
    o = torch.arange(n, device=dev)[:, None]
    hit = (((bits_o[:, None] >> d) & 1) == 1) & (o + d < n)
    partner = torch.clamp(o + d, max=n - 1)
    flat_ex = torch.where(hit, t_of[:, None] * n_tiles + t_of[partner],
                          torch.full_like(partner, n_tiles * n_tiles))
    excl_mat = torch.zeros(n_tiles * n_tiles + 1, dtype=torch.bool,
                           device=dev)
    excl_mat[flat_ex.reshape(-1)] = True
    excl_mat = excl_mat[:-1].reshape(n_tiles, n_tiles)
    excl_mat = excl_mat | excl_mat.t()
    # compact the upper triangle row-major into the fixed-capacity list
    ii = torch.arange(n_tiles, device=dev)
    flat = (cand & (ii[None, :] >= ii[:, None])).reshape(-1)
    count = torch.sum(flat.to(torch.int64))
    overflow = count > cap
    rank = torch.cumsum(flat.to(torch.int64), 0) - 1
    slot = torch.where(flat & (rank < cap), rank, torch.full_like(rank, cap))
    idx = torch.full((cap + 1,), n_tiles * n_tiles, dtype=torch.int64,
                     device=dev)
    idx.scatter_(0, slot, torch.arange(flat.shape[0], device=dev))
    idx = idx[:cap]
    active = idx < n_tiles * n_tiles
    i_t = torch.where(active, idx // n_tiles, torch.zeros_like(idx))
    j_t = torch.where(active, idx % n_tiles, torch.zeros_like(idx))
    first = active & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                i_t[1:] != i_t[:-1]])
    has_ex = active & (excl_mat[i_t, j_t] | (i_t == j_t))
    flags = (active.to(torch.int64) | (has_ex.to(torch.int64) << 1)
             | (first.to(torch.int64) << 2))
    plist = ((i_t << 17) | (j_t << 3) | flags).to(torch.int32)
    if any(nowrap):
        # the kernel's first-atom frame needs every nonempty tile's extent
        # within L/2 - rc_cand - slack on the nowrap axes; a violation
        # folds into ``overflow``
        ext = hi - lo
        budget = 0.5 * box - float(np.float32(rc_cand)) - NOWRAP_SLACK
        for ax in range(3):
            if nowrap[ax]:
                overflow = overflow | torch.any(nonempty
                                                & (ext[:, ax] > budget[ax]))
    # tile-major stacked LJ rows (see PairCache.ab2)
    t_dim = tables["arows"].shape[1]
    av, bv = ab[:, :t_dim], ab[:, t_dim:2 * t_dim]
    if statics["grows"] is not None:
        grows = statics["grows"][perm]
        g = grows.shape[1]
        blocks = [torch.nn.functional.pad(av, (0, g)),
                  torch.nn.functional.pad(bv, (0, g)),
                  torch.nn.functional.pad(grows, (t_dim, 0))]
    else:
        grows = None
        blocks = [av, bv]
    k2 = blocks[0].shape[1]
    ab2 = torch.cat([blk.reshape(n_tiles, ts, k2) for blk in blocks],
                    dim=1).reshape(len(blocks) * n_pad, k2).contiguous()
    # the kernel's per-tile index (see PairCache.row_ptr)
    tiles = torch.arange(n_tiles + 1, device=dev)
    row_key = torch.where(active, i_t, torch.full_like(i_t, n_tiles))
    row_ptr = torch.searchsorted(row_key, tiles)
    col_key = torch.where(active & (i_t != j_t), j_t,
                          torch.full_like(j_t, n_tiles))
    col_idx = torch.sort(col_key, stable=True).indices
    col_ptr = torch.searchsorted(col_key[col_idx], tiles)
    i32 = torch.int32
    blk_tile, blk_e0, blk_ptr = slice_blocks(row_ptr, cap, ts)
    return PairCache(
        perm=perm, invperm=invperm, q=statics["q"][perm].contiguous(),
        bits=statics["bits"][perm].contiguous(), oid=perm.to(i32),
        ljt=statics["ljt"][perm].contiguous(),
        grp=statics["grp"][perm].contiguous(), ab2=ab2, plist=plist,
        cand=cand, overflow=overflow, tile_inert=tile_inert,
        row_ptr=row_ptr.to(i32), col_ptr=col_ptr.to(i32),
        col_idx=col_idx.to(i32), blk_tile=blk_tile, blk_e0=blk_e0,
        blk_ptr=blk_ptr, ab=ab.contiguous(),
        grows=None if grows is None else grows.contiguous())


def plist_coverage_bad(pos_sorted, box, cache: PairCache, ts: int,
                       r_cutoff: float, nowrap=(False, False, False)):
    """Device bool: the pair list would MISS an interacting pair for the
    current positions (some non-candidate tile pair's AABBs, recomputed now
    under the cached sort, come within the cutoff), the list overflowed at
    build, or a nowrap tile outgrew the first-atom-frame budget."""
    box = box.reshape(3)
    valid = pos_sorted[:, 0] < 1e5
    cmean, lo, hi, nonempty = _tile_intervals(pos_sorted, valid, box, ts)
    d2 = _tile_pair_dist2(cmean, lo, hi, box)
    pair_ok = nonempty[:, None] & nonempty[None, :]
    if cache.tile_inert is not None:
        pair_ok = pair_ok & ~(cache.tile_inert[:, None]
                              & cache.tile_inert[None, :])
    out = torch.any((~cache.cand) & pair_ok & (d2 <= _f32_sq(r_cutoff))) \
        | cache.overflow
    if any(nowrap):
        ext = hi - lo
        budget = 0.5 * box - float(np.float32(r_cutoff)) - NOWRAP_SLACK
        for ax in range(3):
            if nowrap[ax]:
                out = out | torch.any(nonempty & (ext[:, ax] > budget[ax]))
    return out


def _tile_intervals_np(pos, box, ts, mode):
    """Host-side (numpy) mirror of the sort + _tile_intervals chain:
    returns (cmean, lo, hi, nonempty, order) with lo/hi relative to cmean."""
    n = pos.shape[0]
    n_pad = ((n + ts - 1) // ts) * ts
    n_tiles = n_pad // ts
    w = pos - box * np.floor(pos / box)
    if mode == "z":
        order = np.argsort(w[:, 2], kind="stable")
    else:
        # the cell in float32, as _morton_key takes it on the device: on a
        # lattice start atoms sit on cell boundaries, where a float64 cell
        # would sort them into other tiles than the list's
        p32, b32 = pos.astype(np.float32), box.astype(np.float32)
        w32 = p32 - b32 * np.floor(p32 / b32)
        cell = np.clip((w32 / b32 * np.float32(64.0)).astype(np.int64), 0, 63)

        def spread(x):
            out = np.zeros_like(x)
            for b in range(6):
                out |= ((x >> b) & 1) << (3 * b)
            return out

        key = spread(cell[:, 0]) | (spread(cell[:, 1]) << 1) | \
            (spread(cell[:, 2]) << 2)
        order = np.argsort(key, kind="stable")
    ws = np.full((n_pad, 3), np.nan)
    ws[:n] = w[order]
    ws = ws.reshape(n_tiles, ts, 3)
    valid = ~np.isnan(ws[:, :, 0])
    v = valid[:, :, None]
    w2 = ws - np.where(ws >= 0.5 * box, box, 0.0)
    lo1 = np.nanmin(np.where(v, ws, np.inf), axis=1)
    hi1 = np.nanmax(np.where(v, ws, -np.inf), axis=1)
    lo2 = np.nanmin(np.where(v, w2, np.inf), axis=1)
    hi2 = np.nanmax(np.where(v, w2, -np.inf), axis=1)
    use2 = (hi2 - lo2) < (hi1 - lo1)
    lo_w = np.where(use2, lo2, lo1)
    hi_w = np.where(use2, hi2, hi1)
    cmean = 0.5 * (lo_w + hi_w)
    nonempty = valid.any(axis=1)
    lo = np.where(nonempty[:, None], lo_w - cmean, 0.0)
    hi = np.where(nonempty[:, None], hi_w - cmean, 0.0)
    cmean = np.where(nonempty[:, None], cmean, 0.0)
    return cmean, lo, hi, nonempty, order


def nowrap_axes_np(pos, box, ts: int, rc_cand: float,
                   mode: str = "morton"):
    """Host-side choice of the plist kernel's first-atom-frame ("nowrap")
    axes for THIS configuration snapshot (see _plist_kernel's _wrap): an
    axis qualifies when the widest tile extent fits the budget
    L/2 - rc_cand - 2*NOWRAP_SLACK.  Double the build-time slack so
    post-init drift cannot flip the runtime checks; the per-step coverage
    check still re-verifies against current positions."""
    pos = np.asarray(pos, np.float64)
    box = np.asarray(box, np.float64).reshape(3)
    _, lo, hi, nonempty, _ = _tile_intervals_np(pos, box, ts, mode)
    ext = (hi - lo)[nonempty]
    if ext.shape[0] == 0:
        return (False, False, False)
    budget = 0.5 * box - rc_cand - 2.0 * NOWRAP_SLACK
    return tuple(bool(ext[:, ax].max() <= budget[ax])
                 for ax in range(3))


def _candidates_np(pos, box, ts, rc_cand, mode, inert):
    """Host-side (numpy) mirror of the AABB candidate enumeration under the
    chosen sort key: the (n_tiles, n_tiles) upper-triangle candidate matrix
    of THIS configuration, and the sort order."""
    pos = np.asarray(pos, np.float64)
    box = np.asarray(box, np.float64).reshape(3)
    n = pos.shape[0]
    n_pad = ((n + ts - 1) // ts) * ts
    n_tiles = n_pad // ts
    cmean, lo, hi, nonempty, order = _tile_intervals_np(pos, box, ts, mode)
    delta = np.mod(cmean[None, :, :] - cmean[:, None, :] + 0.5 * box,
                   box) - 0.5 * box
    gap = np.where(delta >= 0,
                   delta - hi[:, None, :] + lo[None, :, :],
                   -delta - hi[None, :, :] + lo[:, None, :])
    wide = (hi - lo) > 0.5 * box
    gap = np.where(wide[:, None, :] | wide[None, :, :], 0.0, gap)
    gap = np.maximum(gap, 0.0)
    d2 = np.sum(gap * gap, axis=-1)
    cand = (d2 <= rc_cand ** 2) & nonempty[:, None] & nonempty[None, :]
    cand |= np.eye(n_tiles, dtype=bool) & nonempty[:, None]
    if inert is not None:
        # mirror make_pair_cache's inert-inert cull so the capacity (and
        # hence the kernel grid) shrinks with it
        ip = np.ones(n_pad, bool)
        ip[:n] = np.asarray(inert, bool)[order]
        ti = ip.reshape(n_tiles, ts).all(axis=1)
        cand &= ~(ti[:, None] & ti[None, :]
                  & ~np.eye(n_tiles, dtype=bool))
    ii = np.arange(n_tiles)
    return cand & (ii[None, :] >= ii[:, None]), order


def count_candidates_np(pos, box, ts: int, rc_cand: float,
                        mode: str = "morton", inert=None) -> int:
    """The exact candidate tile-pair count for THIS configuration.  Used to
    size the pair-list capacity at evaluator build (cap = margin x count)
    and to pick the better sort key; the runtime overflow flag + full-sweep
    fallback guard the margin."""
    return int(np.sum(_candidates_np(pos, box, ts, rc_cand, mode, inert)[0]))


def count_evaluations_np(pos, box, ts: int, rc_cand: float, r_cutoff: float,
                         mode: str = "morton", inert=None):
    """(entries, evaluations): the candidate tile pairs of THIS configuration
    and a host-side (numpy) model of the pair evaluations kernel B1 makes on
    them after its column skip: for every entry and every chunk of 32 rows,
    the columns of each 32-column chunk within ``r_cutoff`` of the row
    chunk's bounding box (taken about the chunk's first atom, grown by 0.001
    nm), rounded up to the kernel's rounds of four columns, times 32 rows.
    The model leaves out the nowrap frame and the columns an entry with
    exclusions keeps whatever their distance.  ``ForceEvaluator`` sizes its
    tile choice on it."""
    pos = np.asarray(pos, np.float64)
    box = np.asarray(box, np.float64).reshape(3)
    cand, order = _candidates_np(pos, box, ts, rc_cand, mode, inert)
    ti, tj = np.nonzero(cand)
    n = pos.shape[0]
    n_tiles = cand.shape[0]
    nrc = ts // 32
    w = np.full((n_tiles * ts, 3), np.nan)
    w[:n] = (pos - box * np.floor(pos / box))[order]
    chunks = w.reshape(n_tiles * nrc, 32, 3)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-pad chunks
        rel = chunks - box * np.round((chunks - chunks[:, :1]) / box)
        lo, hi = np.nanmin(rel, axis=1), np.nanmax(rel, axis=1)
    mid = (0.5 * (lo + hi)).reshape(n_tiles, nrc, 3)
    half = (0.5 * (hi - lo) + 1e-3).reshape(n_tiles, nrc, 3)
    cols = w.reshape(n_tiles, ts, 3)
    evaluations = 0
    step = max(1, (1 << 21) // (nrc * ts))
    for s in range(0, ti.shape[0], step):
        a, b = ti[s:s + step], tj[s:s + step]
        u = cols[b][:, None, :, :] - mid[a][:, :, None, :]
        u -= box * np.round(u / box)
        gap = np.maximum(np.abs(u) - half[a][:, :, None, :], 0.0)
        with np.errstate(invalid="ignore"):  # pad columns are nan: not kept
            keep = np.sum(gap * gap, axis=-1) <= r_cutoff ** 2 * 1.0001
        kept = keep.reshape(a.shape[0], nrc, nrc, 32).sum(axis=-1)
        evaluations += int((-(-kept // 4) * 4).sum()) * 32
    return int(ti.shape[0]), evaluations


# ------------------------------------------------------------- kernel B1
def _kernel_scalars(beta, r_cutoff):
    return dict(
        rc2=float(np.float32(r_cutoff * r_cutoff)),
        gauss_pref=float(np.float32(2.0 * beta / _SQRT_PI)),
        pcoef=[float(np.float32(c)) for c in _pfit_scaled(float(beta),
                                                          float(r_cutoff))])


def pair_math(r2, qq, a, b, sc, *, beta, r_cutoff, r_switch, want_energy):
    """The per-pair LJ + Ewald arithmetic of kernels B1 and B2, in their
    order: returns (e_lj, f_lj, e_c, erf_inv_r, f_x, f_c, inv_r, inv_r6).
    LJ is (a/r^6)^2 - b/r^6 with 1/r^2 capped at 1e6, so a zero-LJ pad
    pair stays 0 * finite; the bare Coulomb 1/r^3 is capped at 1/0.045^3.
    The energy form takes the A&S erfc (``e_c``, ``erf_inv_r`` set); the
    force-only form the Chebyshev polynomial of ``sc["pcoef"]`` (both
    None)."""
    r2s = torch.clamp(r2, min=1e-10)
    inv_r = torch.rsqrt(r2s)
    inv_r2 = inv_r * inv_r
    inv_r2_lj = torch.clamp(inv_r2, max=1e6)
    inv_r6 = inv_r2_lj * inv_r2_lj * inv_r2_lj
    alj = a * inv_r6
    a12 = alj * alj
    b6 = b * inv_r6
    e_lj = a12 - b6
    f_lj = (12.0 * a12 - 6.0 * b6) * inv_r2_lj
    if r_switch:
        from .allpairs import lj_switch
        e_lj, f_lj = lj_switch(e_lj, f_lj, r2s * inv_r, inv_r, r_switch,
                               r_cutoff)
    e_c = erf_inv_r = None
    if want_energy:
        r = r2s * inv_r
        br = beta * r
        expm = torch.exp(-br * br)
        t = 1.0 / (1.0 + 0.3275911 * br)
        erfc_br = (t * (0.254829592 + t * (-0.284496736
                   + t * (1.421413741 + t * (-1.453152027
                   + t * 1.061405429))))) * expm
        gauss = sc["gauss_pref"] * expm
        e_c = qq * erfc_br * inv_r
        erf_inv_r = (1.0 - erfc_br) * inv_r
        f_x = -qq * (erf_inv_r - gauss) * inv_r2
        f_c = qq * torch.clamp(inv_r * inv_r2, max=_CAP3) + f_x
    else:
        pc = sc["pcoef"]
        pp = torch.full_like(r2s, pc[-1])
        for cof in pc[-2::-1]:
            pp = pp * r2s + cof
        wq = qq * pp
        f_c = qq * torch.clamp(inv_r * inv_r2, max=_CAP3) + wq
        f_x = wq
    return e_lj, f_lj, e_c, erf_inv_r, f_x, f_c, inv_r, inv_r6


def plist_pair_reference(plist, row_ptr, col_ptr, col_idx, pos, q, ab2,
                         ljt, grp, bits, oid, box, *, ts, t_dim, beta,
                         r_cutoff, r_switch=0.0,
                         nowrap=(False, False, False), want_energy=False):
    """Plain torch version of kernel B1: the same ``(rows (n_pad, 8),
    colacc (8, n_pad))`` from the same inputs, vectorised over batches of
    active entries as (ts, ts) blocks.  ``row_ptr``/``col_ptr``/``col_idx``
    (the kernel's reduction index) are unused here: rows and columns are
    summed with ``index_add_`` in list order, the JAX kernel's order."""
    dev = pos.device
    n_pad = pos.shape[0]
    n_tiles = n_pad // ts
    stack = ab2.shape[0] // n_pad
    K = ab2.shape[1]
    sc = _kernel_scalars(beta, r_cutoff)
    rows = torch.zeros((n_tiles, ts, 8), dtype=torch.float32, device=dev)
    cols = torch.zeros((n_tiles, ts, 3), dtype=torch.float32, device=dev)
    words = plist[(plist & 1) == 1].to(torch.int64)
    pos_t = pos.reshape(n_tiles, ts, 3)
    q_t = q.reshape(n_tiles, ts)
    ab2_t = ab2.reshape(n_tiles, stack, ts, K)
    ljt_t = ljt.reshape(n_tiles, ts).to(torch.int64)
    grp_t = grp.reshape(n_tiles, ts).to(torch.int64)
    bits_t = bits.reshape(n_tiles, ts).to(torch.int64)
    oid_t = oid.reshape(n_tiles, ts).to(torch.int64)
    step = max(1, _REF_BATCH_PAIRS // (ts * ts))
    for s in range(0, words.shape[0], step):
        w = words[s:s + step]
        ti = w >> 17
        tj = (w >> 3) & 0x3FFF
        test_excl = torch.full_like(ti, True, dtype=torch.bool) \
            if want_energy else (w & 2) != 0
        diag = ti == tj
        P, C = pos_t[ti], pos_t[tj]                       # (E,ts,3)
        d = []
        for ax in range(3):
            L = box[ax]
            iL = 1.0 / L
            pa, ca = P[:, :, ax], C[:, :, ax]
            if nowrap[ax]:
                c0 = pa[:, 0:1]
                paf = pa - L * torch.round((pa - c0) * iL)
                caf = ca - L * torch.round((ca - c0) * iL)
                d.append(paf[:, :, None] - caf[:, None, :])
            else:
                da = pa[:, :, None] - ca[:, None, :]
                d.append(da - L * torch.round(da * iL))
        dx, dy, dz = d
        r2 = dx * dx + dy * dy + dz * dz
        delta = oid_t[tj][:, None, :] - oid_t[ti][:, :, None]
        bits_lo = torch.where(delta >= 0, bits_t[ti][:, :, None],
                              bits_t[tj][:, None, :])
        dabs = torch.abs(delta)
        dsh = torch.clamp(dabs, max=MAX_EXCL_OFFSET)
        excl = (((bits_lo >> dsh) & 1) > 0) & (dabs <= MAX_EXCL_OFFSET)
        alive = delta != 0
        te = test_excl[:, None, None]
        excl = excl & alive & te
        alive = alive | ~te
        ct = ljt_t[tj]                                    # (E,ts)
        idx = torch.clamp(ct, min=0)[:, None, :].expand(-1, ts, -1)
        rowblk = ab2_t[ti]                                # (E,S,ts,K)
        colok = (ct >= 0)[:, None, :]
        zero = torch.zeros_like(r2)
        a = torch.where(colok, torch.gather(rowblk[:, 0], 2, idx), zero)
        b = torch.where(colok, torch.gather(rowblk[:, 1], 2, idx), zero)
        if stack == 3:
            gidx = (t_dim + grp_t[tj])[:, None, :].expand(-1, ts, -1)
            allowed = torch.gather(rowblk[:, 2], 2, gidx)
            a = a * allowed
            b = b * allowed
        qq = ONE_4PI_EPS0 * q_t[ti][:, :, None] * q_t[tj][:, None, :]
        e_lj, f_lj, e_c, erf_inv_r, f_x, f_c, _, _ = pair_math(
            r2, qq, a, b, sc, beta=beta, r_cutoff=r_cutoff,
            r_switch=r_switch, want_energy=want_energy)
        in_range = alive & ~excl & (r2 < sc["rc2"])
        corr = alive & excl
        f_s = torch.where(in_range, f_lj + f_c, zero) \
            + torch.where(corr, f_x, zero)
        fd = torch.stack([f_s * dx, f_s * dy, f_s * dz], dim=-1)
        blk = torch.zeros((w.shape[0], ts, 8), dtype=torch.float32,
                          device=dev)
        blk[:, :, :3] = torch.sum(fd, dim=2)
        if want_energy:
            half = torch.where(diag, 0.5, 1.0).to(torch.float32)[:, None]
            blk[:, :, 3] = half * torch.sum(
                torch.where(in_range, e_lj, zero), dim=2)
            blk[:, :, 4] = half * torch.sum(
                torch.where(in_range, e_c, zero), dim=2)
            blk[:, :, 5] = half * torch.sum(
                torch.where(corr, -qq * erf_inv_r, zero), dim=2)
        rows.index_add_(0, ti, blk)
        g = -torch.sum(fd, dim=1)                         # (E,ts,3)
        g = torch.where(diag[:, None, None], torch.zeros_like(g), g)
        cols.index_add_(0, tj, g)
    colacc = torch.zeros((8, n_pad), dtype=torch.float32, device=dev)
    colacc[:3] = cols.reshape(n_pad, 3).t()
    return rows.reshape(n_pad, 8), colacc


def _launcher():
    """The kernel library with its C signatures declared (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = kernels.load("plist_pair")
    if lib.plist_pair_launch.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.plist_pair_launch.argtypes = [
            P, I, P, P, P, I, I, I, P, P, P, P, P, I, I, F, F, F, F, F, F,
            ctypes.POINTER(F), I, I, P, P, P, P, P, P, I, I, P, P, P, P, P,
            P]
        lib.plist_pair_launch.restype = I
        lib.plist_pair_error_string.argtypes = [I]
        lib.plist_pair_error_string.restype = ctypes.c_char_p
    return lib


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"plist_pair: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def plist_pair(plist, row_ptr, col_ptr, col_idx, pos, q, ab2, ljt, grp,
               bits, oid, box, *, ts, t_dim, beta, r_cutoff, r_switch=0.0,
               nowrap=(False, False, False), want_energy=False,
               blocks=None, evals=None):
    """The plist pair sweep: returns (rows (n_pad, 8), colacc (8, n_pad)).

    On a CUDA tensor this launches kernel B1 (``csrc/plist_pair.cu``) on the
    current stream and counts the launch in ``plist_pair.launches``; on a
    CPU tensor it runs ``plist_pair_reference``.  There is no fallback: a
    CUDA call the kernel cannot take raises.  ``ts`` is a multiple of 32
    from 32 to 384.  ``blocks`` is ``slice_blocks(row_ptr, cap, ts)`` (a
    cache carries it; built here when not given).  ``evals``, a one-element
    int64 CUDA tensor, has the kernel add the pair evaluations it makes
    after its column skip (a measurement aid; the CPU version ignores
    it)."""
    dev = pos.device
    if dev.type == "cpu":
        return plist_pair_reference(
            plist, row_ptr, col_ptr, col_idx, pos, q, ab2, ljt, grp, bits,
            oid, box, ts=ts, t_dim=t_dim, beta=beta, r_cutoff=r_cutoff,
            r_switch=r_switch, nowrap=nowrap, want_energy=want_energy)
    if dev.type != "cuda":
        raise ValueError(f"plist_pair: unsupported device {dev}")
    if ts % 32 or not 32 <= ts <= 384:
        raise ValueError(f"plist_pair: ts must be a multiple of 32 from 32 "
                         f"to 384, got {ts}")
    n_pad = pos.shape[0]
    n_tiles = n_pad // ts
    cap = plist.shape[0]
    stack = ab2.shape[0] // n_pad
    i32, f32 = torch.int32, torch.float32
    _check(plist, "plist", i32, (cap,), dev)
    _check(row_ptr, "row_ptr", i32, (n_tiles + 1,), dev)
    _check(col_ptr, "col_ptr", i32, (n_tiles + 1,), dev)
    _check(col_idx, "col_idx", i32, (cap,), dev)
    _check(pos, "pos", f32, (n_tiles * ts, 3), dev)
    _check(q, "q", f32, (n_pad,), dev)
    _check(ab2, "ab2", f32, (stack * n_pad, ab2.shape[1]), dev)
    for name, t in (("ljt", ljt), ("grp", grp), ("bits", bits),
                    ("oid", oid)):
        _check(t, name, i32, (n_pad,), dev)
    _check(box, "box", f32, (3,), dev)
    if stack not in (2, 3):
        raise ValueError("plist_pair: ab2 must stack 2 or 3 blocks")
    if evals is not None:
        _check(evals, "evals", torch.int64, (1,), dev)
    sc = _kernel_scalars(beta, r_cutoff)
    rows = torch.empty((n_pad, 8), dtype=f32, device=dev)
    colacc = torch.empty((8, n_pad), dtype=f32, device=dev)
    if blocks is None:
        blocks = slice_blocks(row_ptr, cap, ts)
    blk_tile, blk_e0, blk_ptr = blocks
    n_blocks = cap // slice_entries(ts) + n_tiles
    _check(blk_tile, "blocks[0]", i32, (n_blocks,), dev)
    _check(blk_e0, "blocks[1]", i32, (n_blocks,), dev)
    _check(blk_ptr, "blocks[2]", i32, (n_tiles + 1,), dev)
    lib = _launcher()
    prow = torch.empty((n_blocks, 6, ts), dtype=f32, device=dev)
    pcol = torch.empty((cap, ts // 32, 3, ts), dtype=f32, device=dev)
    pcoef = (ctypes.c_float * len(sc["pcoef"]))(*sc["pcoef"])
    nw = int(nowrap[0]) | (int(nowrap[1]) << 1) | (int(nowrap[2]) << 2)
    err = lib.plist_pair_launch(
        plist.data_ptr(), cap, pos.data_ptr(), q.data_ptr(), ab2.data_ptr(),
        ab2.shape[1], t_dim, stack, ljt.data_ptr(), grp.data_ptr(),
        bits.data_ptr(), oid.data_ptr(), box.data_ptr(), n_pad, ts,
        float(beta), sc["rc2"], float(r_cutoff), float(r_switch), _CAP3,
        sc["gauss_pref"], pcoef, nw, int(bool(want_energy)),
        row_ptr.data_ptr(), col_ptr.data_ptr(), col_idx.data_ptr(),
        blk_tile.data_ptr(), blk_e0.data_ptr(), blk_ptr.data_ptr(),
        n_blocks, slice_entries(ts), prow.data_ptr(), pcol.data_ptr(),
        rows.data_ptr(), colacc.data_ptr(),
        None if evals is None else evals.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("plist_pair kernel launch failed: "
                           + lib.plist_pair_error_string(err).decode())
    plist_pair.launches += 1
    return rows, colacc


plist_pair.launches = 0


def sweep(cache: PairCache, pos_sorted, box, *, ts, t_dim, beta, r_cutoff,
          r_switch=0.0, nowrap=(False, False, False), want_energy=False):
    """``plist_pair`` on a cache's fields."""
    return plist_pair(
        cache.plist, cache.row_ptr, cache.col_ptr, cache.col_idx,
        pos_sorted, cache.q, cache.ab2, cache.ljt, cache.grp, cache.bits,
        cache.oid, box, ts=ts, t_dim=t_dim, beta=beta, r_cutoff=r_cutoff,
        r_switch=r_switch, nowrap=nowrap, want_energy=want_energy,
        blocks=(cache.blk_tile, cache.blk_e0, cache.blk_ptr))


# ------------------------------------------------------------- the sweep
def residual_adjustment(pos, box, charges, tables, beta, r_cutoff,
                        e_lj, e_coul, e_corr, forces, r_switch=0.0):
    """Exclusion pairs beyond the 31-offset window: subtract their
    direct-space contribution, add the reciprocal correction."""
    if tables["residual"].shape[0] == 0:
        return e_lj, e_coul, e_corr, forces
    d_lj, d_coul, d_corr, i, j, f_adj = residual_pair_terms(
        pos, box, charges, tables, beta, r_cutoff, r_switch)
    forces = forces.index_add(0, i, f_adj).index_add(0, j, -f_adj)
    return e_lj + d_lj, e_coul + d_coul, e_corr + d_corr, forces


def direct_space_plist(pos, box, charges, tables, beta, r_cutoff, ts: int,
                       want_energy: bool = True,
                       cache: Optional[PairCache] = None,
                       plist_cap: int = 0, skin: float = 0.1,
                       plist_sort: str = "morton", r_switch: float = 0.0,
                       strict: bool = False, nowrap=(False, False, False),
                       statics=None):
    """The plist branch of the JAX ``direct_space_pallas``.  Returns
    (e_lj, e_coul, e_corr, e14_coul, e14_lj, forces, coverage_bad); the two
    1-4 energies are zero (1-4 folding runs only in the band sweep).

    Without ``cache`` the sort and list are built here (energy queries).
    ``strict=False`` runs the list unconditionally: a step whose coverage
    flag trips may miss a pair just entering the cutoff, and the caller
    rebuilds the cache at once.  ``strict=True`` reads the flag on the host
    before the sweep (the step's one synchronisation) and, when it is set,
    runs the exhaustive sorted-layout sweep of kernel B2 instead
    (``pair_tri.run_tri(full_sweep=True)``, the JAX ``lax.cond`` branch);
    the flag then comes back as a Python bool."""
    dev = pos.device
    box = box.reshape(3)
    if cache is None:
        cache = make_pair_cache(pos, box, charges, tables, ts,
                                mode=plist_sort, cap=plist_cap,
                                rc_cand=r_cutoff + skin, nowrap=nowrap,
                                statics=statics)
    n = pos.shape[0]
    pad = cache.perm.shape[0] - n
    pos2d = torch.cat([pos, torch.full((pad, 3), 1e6, dtype=torch.float32,
                                       device=dev)])[cache.perm]
    flag = plist_coverage_bad(pos2d, box, cache, ts, r_cutoff, nowrap=nowrap)
    t_dim = tables["arows"].shape[1]
    if strict:
        flag = bool(flag)
    if strict and flag:
        from .pair_tri import run_tri
        rows, colacc = run_tri(
            pos2d, cache.q, cache.ab, cache.bits, cache.bits, cache.oid,
            cache.ljt, cache.grp, cache.grows, box, ts=ts, t_dim=t_dim,
            beta=beta, r_cutoff=r_cutoff, has14=False, full_sweep=True,
            want_energy=want_energy, r_switch=r_switch)
    else:
        rows, colacc = sweep(
            cache, pos2d, box, ts=ts, t_dim=t_dim, beta=beta,
            r_cutoff=r_cutoff, r_switch=r_switch, nowrap=nowrap,
            want_energy=want_energy)
    f_full = rows[:, :3] + colacc[:3, :].t()
    forces = f_full[cache.invperm][:n]
    e_lj = torch.sum(rows[:, 3])
    e_coul = torch.sum(rows[:, 4])
    e_corr = torch.sum(rows[:, 5])
    e_lj, e_coul, e_corr, forces = residual_adjustment(
        pos, box, charges, tables, beta, r_cutoff, e_lj, e_coul, e_corr,
        forces, r_switch=r_switch)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    return e_lj, e_coul, e_corr, z, z, forces, flag
