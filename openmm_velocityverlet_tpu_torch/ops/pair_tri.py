"""The upper-triangle tile sweep and kernel B2 (counterpart of the band half
of ``openmm_velocityverlet_tpu/ops/pallas_pair.py``: the z-sort
``make_pair_cache`` without a list, ``band_eligible``,
``band_coverage_bad``, ``_run_tri`` and the symmetric band branch of
``direct_space_pallas``).  The JAX names are kept so each counterpart is
easy to find.

Atoms are sorted by wrapped z and cut into tiles of ``ts`` atoms; Newton's
third law halves the pair work, so each unordered tile pair is visited
once.  ``tri_pair`` runs one enumeration of tile pairs (a "mode"):

* ``band``: j = i, i+1 on the unsorted layout, exclusions tested on index
  positions;
* ``far``: j >= i+2 on the unsorted layout, cutoff mask only (exclusions
  span at most 31 < ts positions, so no excluded pair is that far apart);
* ``bandall``: the z-banded sorted sweep, j = (i+o) mod n_tiles for
  o = 0..band_w, exclusions tested on the carried original indices;
  with ``full_sweep`` every unordered tile pair (band_w = n_tiles // 2,
  the pair at offset n_tiles / 2 kept once when n_tiles is even).

On a CUDA tensor ``tri_pair`` launches kernel B2 (``csrc/tri_pair.cu``);
on a CPU tensor it takes the plain torch version ``tri_pair_reference``,
which computes the same ``(rows (n_pad, 8), colacc (8, n_pad))``.

Kernel B2 evaluates a pair only where a vote of its warp finds the column
in reach of a chunk of 32 consecutive rows.  Two things here are for that
skip: ``make_pair_cache(inner_order=True)`` orders the slots inside each
z-sorted tile so that a chunk is a compact rectangle of the tile's slab,
and ``chunk_pair_map`` marks the chunk pairs that hold an excluded or
folded 1-4 pair, which the skip must leave alone.  ``skip_model_np`` is a
numpy model of what the kernel then evaluates.  ``tri_pair`` also has the
JAX kernel's row-sharded form (``row_off``, ``n_tiles_g``); the
multi-device sweep that would call it is not ported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..units import ONE_4PI_EPS0
from .pair_plist import (_CAP3, _REF_BATCH_PAIRS, MAX_EXCL_OFFSET,
                         _kernel_scalars, pair_math, residual_adjustment)

MODES = ("band", "far", "bandall")


class BandCache(NamedTuple):
    """The z-sorted layout of the band sweep (the JAX ``PairCache`` of
    ``mode="z"`` without a list), rebuilt every few dozen steps; the
    per-step ``band_coverage_bad`` runs against current positions, so a
    stale sort stays safe.  Per-atom fields are sorted and n_pad long."""
    perm: torch.Tensor       # (n_pad,) int64 sorted slot -> original index
    invperm: torch.Tensor    # (n_pad,) int64
    q: torch.Tensor          # (n_pad,) f32 charges
    ab: torch.Tensor         # (n_pad, 2T or 4T) f32 [A | B (| A14 | B14)]
    bits: torch.Tensor       # (n_pad,) i32 exclusion masks
    bits14: torch.Tensor     # (n_pad,) i32 folded 1-4 masks (bits14_2d)
    oid: torch.Tensor        # (n_pad,) i32 original indices (perm)
    ljt: torch.Tensor        # (n_pad,) i32 LJ type, -1 on pad atoms
    grp: torch.Tensor        # (n_pad,) i32 interaction group
    grows: Optional[torch.Tensor]  # (n_pad, G) f32 group rows or None
    # (n_pad/32, words) i32 bitmap of the 32-atom chunk pairs that hold an
    # excluded or folded 1-4 pair (``chunk_pair_map``): kernel B2's column
    # skip leaves those alone
    cmap: Optional[torch.Tensor] = None


def band_statics(charges, tables, n_pad, device):
    """Original-order per-atom columns padded to ``n_pad`` (q, ab, bits,
    bits14, ljt, grp, grows or None) on ``device``: the unsorted layout of
    the band + far sweep, and the source that ``make_pair_cache`` permutes,
    with ``cmap``, the marked chunk pairs of that unsorted layout.  Pad
    atoms carry zero charge, zero LJ rows and type -1.  Build once per
    system and tile size."""
    n = tables["arows"].shape[0]
    pad = n_pad - n
    has14 = bool(tables.get("has_exc14", False))

    def col(a, fill, dtype):
        a = np.asarray(a)
        full = np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)
        return torch.as_tensor(full.astype(dtype), device=device)

    parts = [tables["arows"], tables["brows"]]
    if has14:
        parts += [tables["a14rows"], tables["b14rows"]]
    groups = tables["grows"] is not None
    marks = np.asarray(tables["excl_bits"]).astype(np.int64)
    if has14:
        marks = marks | np.asarray(tables["exc14_bits"]).astype(np.int64)
    return dict(
        cmap=chunk_pair_map(col(marks, 0, np.int32), None),
        q=col(np.asarray(charges, np.float32), 0.0, np.float32),
        ab=col(np.concatenate(parts, 1), 0.0, np.float32),
        bits=col(tables["excl_bits"], 0, np.int32),
        bits14=col(tables["exc14_bits"] if has14 else np.zeros(n, np.int32),
                   0, np.int32),
        ljt=col(np.argmax(tables["onehot"], axis=1), -1, np.int32),
        grp=col(np.argmax(tables["gonehot"], axis=1) if groups
                else np.zeros(n, np.int64), 0, np.int32),
        grows=col(tables["grows"], 0.0, np.float32) if groups else None)


def padded_size(n: int, ts: int, tile_multiple: int = 1) -> int:
    blk = ts * max(int(tile_multiple), 1)
    return -(-n // blk) * blk


def chunk_pair_map(marks, ids):
    """(n_pad/32, ceil(n_pad/1024)) int32 bitmap over (row chunk, column
    chunk) of 32 consecutive slots each: bit c of row r is set where some
    atom of chunk r has an excluded or folded 1-4 partner in chunk c, and
    for c = r.  ``marks`` (n_pad,) int32 is the union of the exclusion and
    1-4 masks in layout order (bit d of an atom: its partner is the atom d
    original indices on); ``ids`` (n_pad,) the original index of each slot
    (a permutation of 0 .. n_pad - 1), None for the unsorted layout.
    Kernel B2 never skips a column of a marked chunk pair, tests the masks
    only there, and takes the minimum image per pair there.  Device ops
    only, no host synchronisation."""
    dev = marks.device
    n_pad = marks.shape[0]
    nc = n_pad // 32
    nw = -(-nc // 32)
    slot = torch.arange(n_pad, device=dev)
    ids = slot if ids is None else ids.to(torch.int64)
    inv = torch.empty_like(slot)
    inv[ids] = slot
    d = torch.arange(1, MAX_EXCL_OFFSET + 1, device=dev)
    partner = ids[:, None] + d
    hit = (((marks.to(torch.int64)[:, None] >> d) & 1) == 1) \
        & (partner < n_pad)
    pslot = inv[torch.clamp(partner, max=n_pad - 1)]
    flat = torch.where(hit, (slot[:, None] // 32) * nc + pslot // 32,
                       torch.full_like(pslot, nc * nc))
    mat = torch.zeros(nc * nc + 1, dtype=torch.bool, device=dev)
    mat[flat.reshape(-1)] = True
    mat = mat[:-1].reshape(nc, nc)
    mat = mat | mat.t() | torch.eye(nc, dtype=torch.bool, device=dev)
    mat = torch.nn.functional.pad(mat, (0, nw * 32 - nc)).reshape(nc, nw, 32)
    words = torch.sum(mat.to(torch.int64)
                      << torch.arange(32, device=dev), dim=2)
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32).contiguous()


def chunk_pair_marked(cmap):
    """The (n_chunks, n_chunks) bool matrix of a ``chunk_pair_map``."""
    nc, nw = cmap.shape
    bit = torch.arange(32, device=cmap.device)
    return (((cmap.to(torch.int64)[:, :, None] >> bit) & 1) == 1).reshape(
        nc, nw * 32)[:, :nc]


def inner_strips(ts: int) -> int:
    """Strips along x that the inner order cuts a tile into: the divisor of
    the tile's ts / 32 chunks nearest to their square root, so that a chunk
    (a run of a strip along y) is as square a patch as the count allows."""
    nrc = ts // 32
    return min((d for d in range(1, nrc + 1) if nrc % d == 0),
               key=lambda d: (abs(d * d - nrc), d))


def _inner_order(perm, pos, box, ts: int):
    """Reorder the slots inside each tile of a z-sorted ``perm``: the tile's
    atoms are cut along wrapped x into ``inner_strips(ts)`` strips of equal
    count and each strip runs along wrapped y, so 32 consecutive slots are a
    rectangle of the tile's slab.  Stable sorts on float32 keys (a host
    mirror with numpy's stable sort gives the same order); pads sort last."""
    n, n_pad = pos.shape[0], perm.shape[0]
    dev = pos.device
    xy, bxy = pos[:, :2].to(torch.float32), box[:2]
    w = xy - bxy * torch.floor(xy / bxy)
    w = torch.cat([w, torch.full((n_pad - n, 2), 1e30, dtype=torch.float32,
                                 device=dev)])
    slot = torch.arange(n_pad, device=dev)
    strip = slot // ts * inner_strips(ts) \
        + slot % ts // (ts // inner_strips(ts))
    for axis, group in ((0, slot // ts), (1, strip)):
        # lexicographic (group of the slot, coordinate): two stable sorts
        by_coord = torch.sort(w[perm, axis], stable=True).indices
        perm = perm[by_coord[torch.sort(group[by_coord],
                                        stable=True).indices]]
    return perm


def make_pair_cache(pos, box, charges, tables, ts: int,
                    tile_multiple: int = 1, statics=None,
                    inner_order: bool = False) -> BandCache:
    """Sort atoms by wrapped z and permute the static columns.
    ``tile_multiple`` rounds the tile count up to a multiple (the JAX
    row-sharded sweep's layout).  ``perm`` is bit-identical to the JAX
    ``make_pair_cache(mode="z")``: a stable sort on the same float32 keys
    is ``lax.sort((keys, iota), num_keys=2)``.

    ``inner_order=True`` then orders the slots inside each tile in strips
    along x that run along y (``_inner_order``).  A tile keeps its atoms, so the enumeration,
    ``band_eligible`` and ``band_coverage_bad`` see the same tiles and the
    sweep differs from the z order only in summation order; but 32
    consecutive slots, the unit of kernel B2's column skip, are then a
    compact patch of the tile's slab and not a sheet across the box.  (A
    2-D Morton curve does not do: a run of 32 points that crosses one of
    its quadrant boundaries has a bounding box many times the run's area.)
    The cache carries ``cmap`` (``chunk_pair_map``) for its layout."""
    dev = pos.device
    n = pos.shape[0]
    n_pad = padded_size(n, ts, tile_multiple)
    if statics is None or statics["q"].shape[0] != n_pad:
        statics = band_statics(charges, tables, n_pad, dev)
    box = torch.as_tensor(box, dtype=torch.float32, device=dev).reshape(3)
    lz = box[2]
    zw = pos[:, 2].to(torch.float32)
    zw = zw - lz * torch.floor(zw / lz)
    keys = torch.cat([zw, torch.full((n_pad - n,), 1e30,
                                     dtype=torch.float32, device=dev)])
    perm = torch.sort(keys, stable=True).indices
    if inner_order:
        perm = _inner_order(perm, pos, box, ts)
    invperm = torch.empty_like(perm)
    invperm[perm] = torch.arange(n_pad, device=dev)
    grows = statics["grows"]
    marks = statics["bits"] | statics["bits14"]
    return BandCache(
        cmap=chunk_pair_map(marks[perm], perm),
        perm=perm, invperm=invperm, q=statics["q"][perm].contiguous(),
        ab=statics["ab"][perm].contiguous(),
        bits=statics["bits"][perm].contiguous(),
        bits14=statics["bits14"][perm].contiguous(),
        oid=perm.to(torch.int32), ljt=statics["ljt"][perm].contiguous(),
        grp=statics["grp"][perm].contiguous(),
        grows=None if grows is None else grows[perm].contiguous())


def band_eligible(n_pad: int, ts: int, band_w: int) -> bool:
    """True when the banded enumeration covers every unordered tile pair
    exactly once."""
    n_tiles = n_pad // ts
    return band_w >= 1 and n_tiles >= 2 * band_w + 1 and n_tiles >= 3


@functools.lru_cache(maxsize=16)
def _uncovered(n_tiles: int, n_ring: int, band_w: int, device: str):
    """(T,T) bool: tile pairs the band does not visit, with wrap offsets
    taken on the ring of tiles that hold real atoms."""
    off = (np.arange(n_tiles)[None, :] - np.arange(n_tiles)[:, None]) \
        % n_ring
    covered = np.minimum(off, n_ring - off) <= band_w
    return torch.as_tensor(~covered, device=device)


def band_coverage_bad(pos, box, cache: BandCache, ts: int, band_w: int,
                      r_cutoff: float):
    """Device bool: the banded sweep would MISS an interacting pair for the
    current positions under the cached sort (some uncovered tile pair's
    circular z-interval gap is within the cutoff, or a tile's interval is
    degenerate).  Intervals are taken around each tile's circular mean, so
    atoms that wrapped across the z boundary since the sort do not widen
    them to the whole box."""
    n = pos.shape[0]
    n_pad = cache.perm.shape[0]
    n_tiles = n_pad // ts
    dev = pos.device
    lz = box.reshape(3)[2]
    zw = pos[:, 2] - lz * torch.floor(pos[:, 2] / lz)
    keys = torch.cat([zw.to(torch.float32),
                      torch.full((n_pad - n,), 1e30, dtype=torch.float32,
                                 device=dev)])
    skeys = keys[cache.perm].reshape(n_tiles, ts)
    valid = (cache.perm < n).reshape(n_tiles, ts)
    nonempty = valid.any(dim=1)
    two_pi = float(np.float32(2.0 * np.pi))
    theta = skeys * (two_pi / lz)
    zero = torch.zeros_like(theta)
    sn = torch.sum(torch.where(valid, torch.sin(theta), zero), dim=1)
    cs = torch.sum(torch.where(valid, torch.cos(theta), zero), dim=1)
    cmean = torch.atan2(sn, cs) * (lz / two_pi)
    dz = torch.remainder(skeys - cmean[:, None] + 0.5 * lz, lz) - 0.5 * lz
    inf = torch.full_like(dz, float("inf"))
    lo = torch.amin(torch.where(valid, dz, inf), dim=1)
    hi = torch.amax(torch.where(valid, dz, -inf), dim=1)
    width_bad = (hi - lo) > 0.5 * lz
    delta = torch.remainder(cmean[None, :] - cmean[:, None] + 0.5 * lz,
                            lz) - 0.5 * lz
    gap = torch.where(delta >= 0, delta - hi[:, None] + lo[None, :],
                      -delta - hi[None, :] + lo[:, None])
    n_ring = -(-n // ts)
    bad = _uncovered(n_tiles, n_ring, int(band_w), str(dev)) \
        & ((gap <= r_cutoff) | width_bad[:, None] | width_bad[None, :]) \
        & nonempty[:, None] & nonempty[None, :]
    return torch.any(bad)


# ------------------------------------------------------------- kernel B2
def n_entries(mode: str, n_tiles: int, band_w: int) -> int:
    """Grid size of one enumeration: bandall n_tiles*(band_w+1), band
    2*n_tiles, far n_tiles^2 (inactive entries skip)."""
    if mode == "bandall":
        return n_tiles * (band_w + 1)
    return 2 * n_tiles if mode == "band" else n_tiles * n_tiles


def tile_pairs(mode: str, n_tiles: int, band_w: int = 0,
               full_sweep: bool = False, row_off: int = 0,
               n_tiles_g: int = 0, n_row_tiles: int = 0):
    """(i, j) int64 arrays of the active tile pairs of one enumeration, in
    the kernel's entry order (the JAX grid order).  In the row-sharded form
    of ``bandall`` the rows are the ``n_row_tiles`` tiles from ``row_off``
    on, ``i`` is the global row tile and the column wraps on the ring of
    ``n_tiles_g`` tiles."""
    if mode == "bandall":
        ntg = n_tiles_g or n_tiles
        e = np.arange(n_entries(mode, n_row_tiles or n_tiles - row_off,
                                band_w))
        i, o = e // (band_w + 1) + row_off, e % (band_w + 1)
        j = (i + o) % ntg
        active = np.ones_like(e, bool)
        if full_sweep and ntg % 2 == 0:
            # offset ntg/2 enumerates each unordered pair twice
            active = (2 * o != ntg) | (i < j)
        return i[active], j[active]
    e = np.arange(n_entries(mode, n_tiles, band_w))
    if mode == "band":
        i = e // 2
        j = i + e % 2
        active = j < n_tiles
    else:
        i, j = e // n_tiles, e % n_tiles
        active = j >= i + 2
    return i[active], j[active]


def _row_tiles(mode, n_tiles, row_off, n_tiles_g, n_row_tiles) -> int:
    """The number of row tiles of one call, after checking the row-sharded
    arguments (``bandall`` only)."""
    if not (row_off or n_tiles_g or n_row_tiles):
        return n_tiles
    if mode != "bandall":
        raise ValueError("tri_pair: row_off / n_tiles_g / n_row_tiles "
                         "belong to the bandall mode")
    n_rt = n_row_tiles or n_tiles - row_off
    if row_off < 0 or n_rt < 1 or row_off + n_rt > n_tiles \
            or not 0 <= n_tiles_g <= n_tiles:
        raise ValueError(
            f"tri_pair: row tiles [{row_off}, {row_off + n_rt}) on a ring "
            f"of {n_tiles_g} do not fit {n_tiles} tiles")
    return n_rt


def tri_pair_reference(pos, q, ab, bits, bits14, oid, ljt, grp, grows, box,
                       *, ts, t_dim, beta, r_cutoff, mode, band_w=0,
                       full_sweep=False, want_energy=True, has14=False,
                       r_switch=0.0, row_off=0, n_tiles_g=0, n_row_tiles=0):
    """Plain torch version of kernel B2 (the JAX ``_pair_tri_kernel``):
    the same ``(rows (n_pad, 8), colacc (8, n_pad))`` from the same inputs,
    vectorised over batches of tile pairs as (ts, ts) blocks.  rows hold
    fx, fy, fz, e_lj, e_coul, e_corr, e14_coul, e14_lj; colacc rows 0..2
    the Newton reaction (none on a diagonal tile).  It evaluates every pair
    of the enumeration: it is the oracle of the kernel's column skip, not a
    model of it.  ``row_off`` / ``n_tiles_g`` / ``n_row_tiles``: see
    ``tri_pair``."""
    if mode not in MODES:
        raise ValueError(f"tri_pair: unknown mode {mode!r}")
    dev = pos.device
    n_pad = pos.shape[0]
    n_tiles = n_pad // ts
    n_rt = _row_tiles(mode, n_tiles, row_off, n_tiles_g, n_row_tiles)
    test_excl = mode != "far"
    sc = _kernel_scalars(beta, r_cutoff)
    i_np, j_np = tile_pairs(mode, n_tiles, band_w, full_sweep, row_off,
                            n_tiles_g, n_row_tiles)
    rows = torch.zeros((n_rt, ts, 8), dtype=torch.float32, device=dev)
    cols = torch.zeros((n_tiles, ts, 3), dtype=torch.float32, device=dev)
    if i_np.size == 0:
        return rows.reshape(n_rt * ts, 8), torch.zeros(
            (8, n_pad), dtype=torch.float32, device=dev)
    pos_t = pos.reshape(n_tiles, ts, 3)
    q_t = q.reshape(n_tiles, ts)
    # "band" tests exclusions on index positions, "bandall" on the carried
    # original indices
    ids = torch.arange(n_pad, device=dev) if mode == "band" else oid
    ids_t = ids.reshape(n_tiles, ts).to(torch.int64)
    bits_t = bits.reshape(n_tiles, ts).to(torch.int64)
    b14_t = bits14.reshape(n_tiles, ts).to(torch.int64)
    ab_t = ab.reshape(n_tiles, ts, ab.shape[1])
    ljt_t = ljt.reshape(n_tiles, ts).to(torch.int64)
    grp_t = grp.reshape(n_tiles, ts).to(torch.int64)
    grows_t = None if grows is None else grows.reshape(n_tiles, ts, -1)
    rc2 = sc["rc2"]
    step = max(1, _REF_BATCH_PAIRS // (ts * ts))
    for s in range(0, i_np.size, step):
        ti = torch.as_tensor(i_np[s:s + step], device=dev)
        tj = torch.as_tensor(j_np[s:s + step], device=dev)
        diag = ti == tj
        P, C = pos_t[ti], pos_t[tj]                       # (E,ts,3)
        d = []
        for ax in range(3):
            L = box[ax]
            da = P[:, :, None, ax] - C[:, None, :, ax]
            d.append(da - L * torch.round(da * (1.0 / L)))
        dx, dy, dz = d
        r2 = dx * dx + dy * dy + dz * dz
        zero = torch.zeros_like(r2)
        ct = ljt_t[tj]                                    # (E,ts)
        colok = (ct >= 0)[:, None, :]
        idx = torch.clamp(ct, min=0)[:, None, :].expand(-1, ts, -1)
        rowab = ab_t[ti]                                  # (E,ts,W)

        def lookup(k):
            return torch.where(colok, torch.gather(
                rowab[:, :, k * t_dim:(k + 1) * t_dim], 2, idx), zero)

        a, b = lookup(0), lookup(1)
        if grows_t is not None:
            gidx = grp_t[tj][:, None, :].expand(-1, ts, -1)
            allowed = torch.gather(grows_t[ti], 2, gidx)
            a = a * allowed
            b = b * allowed
        qq = ONE_4PI_EPS0 * q_t[ti][:, :, None] * q_t[tj][:, None, :]
        e_lj, f_lj, e_c, erf_inv_r, f_x, f_c, inv_r, inv_r6 = pair_math(
            r2, qq, a, b, sc, beta=beta, r_cutoff=r_cutoff,
            r_switch=r_switch, want_energy=want_energy)
        blk = torch.zeros((ti.shape[0], ts, 8), dtype=torch.float32,
                          device=dev)
        half = torch.where(diag, 0.5, 1.0).to(torch.float32)[:, None]
        if test_excl:
            delta = ids_t[tj][:, None, :] - ids_t[ti][:, :, None]
            side = delta >= 0
            dabs = torch.abs(delta)
            dsh = torch.clamp(dabs, max=MAX_EXCL_OFFSET)
            window = dabs <= MAX_EXCL_OFFSET
            alive = delta != 0
            bits_lo = torch.where(side, bits_t[ti][:, :, None],
                                  bits_t[tj][:, None, :])
            excl = (((bits_lo >> dsh) & 1) > 0) & window & alive
            in_range = alive & ~excl & (r2 < rc2)
            corr = alive & excl
            f_s = torch.where(in_range, f_lj + f_c, zero) \
                + torch.where(corr, f_x, zero)
            if has14:
                b14_lo = torch.where(side, b14_t[ti][:, :, None],
                                     b14_t[tj][:, None, :])
                pair14 = (((b14_lo >> dsh) & 1) > 0) & window & alive
                a14, b14 = lookup(2), lookup(3)
                inv_r2 = inv_r * inv_r
                e14_c = 0.5 * qq * inv_r
                a14lj = a14 * inv_r6
                e14_12 = a14lj * a14lj
                e14_6 = b14 * inv_r6
                f14 = (e14_c + 12.0 * e14_12 - 6.0 * e14_6) * inv_r2
                f_s = f_s + torch.where(pair14, f14, zero)
                if want_energy:
                    blk[:, :, 6] = half * torch.sum(
                        torch.where(pair14, e14_c, zero), dim=2)
                    blk[:, :, 7] = half * torch.sum(
                        torch.where(pair14, e14_12 - e14_6, zero), dim=2)
            if want_energy:
                blk[:, :, 5] = half * torch.sum(
                    torch.where(corr, -qq * erf_inv_r, zero), dim=2)
        else:
            in_range = r2 < rc2
            f_s = torch.where(in_range, f_lj + f_c, zero)
        fd = torch.stack([f_s * dx, f_s * dy, f_s * dz], dim=-1)
        blk[:, :, :3] = torch.sum(fd, dim=2)
        if want_energy:
            blk[:, :, 3] = half * torch.sum(
                torch.where(in_range, e_lj, zero), dim=2)
            blk[:, :, 4] = half * torch.sum(
                torch.where(in_range, e_c, zero), dim=2)
        rows.index_add_(0, ti - row_off, blk)
        g = -torch.sum(fd, dim=1)                         # (E,ts,3)
        g = torch.where(diag[:, None, None], torch.zeros_like(g), g)
        cols.index_add_(0, tj, g)
    colacc = torch.zeros((8, n_pad), dtype=torch.float32, device=dev)
    colacc[:3] = cols.reshape(n_pad, 3).t()
    return rows.reshape(n_rt * ts, 8), colacc


def tri_tiling(mode: str, ts: int, n_tiles: int, band_w: int = 0):
    """How kernel B2 cuts one enumeration, from the shapes alone: returns
    (n_ept entries a row tile, n_items items a row chunk, splits, per).  An
    item is (entry, column chunk of 32 atoms); a row chunk's items go to
    ``splits`` warps of ``per`` consecutive items each, about 16 a warp, so
    that a wide band or the full sweep does not hang on one warp."""
    n_ept = n_entries(mode, 1, band_w) if mode != "far" else n_tiles
    n_items = n_ept * (ts // 32)
    splits = max(1, min(64, -(-n_items // 16)))
    return n_ept, n_items, splits, -(-n_items // splits)


def _chunk_boxes_np(pos, real, box):
    """Centre, half extent (grown by 0.001 nm) and non-emptiness of every
    32-slot chunk's bounding box over its real atoms, in the frame of the
    chunk's first real atom, and the positions in that frame: the numpy
    mirror of csrc/tri_pair.cu:chunk_box."""
    nc = pos.shape[0] // 32
    p = pos.reshape(nc, 32, 3)
    r = real.reshape(nc, 32)
    first = np.argmax(r, axis=1)
    f = p[np.arange(nc), first][:, None, :]
    w = p - box * np.round((p - f) / box)
    lo = np.where(r[:, :, None], w, np.inf).min(axis=1)
    hi = np.where(r[:, :, None], w, -np.inf).max(axis=1)
    any_ = r.any(axis=1)
    mid = np.where(any_[:, None], 0.5 * (lo + hi), 0.0)
    half = np.where(any_[:, None], 0.5 * (hi - lo) + 1e-3, 0.0)
    return mid, half, any_, w.reshape(-1, 3)


def skip_model_np(pos, real, box, marked, ts: int, r_cutoff: float,
                  mode: str = "bandall", band_w: int = 0,
                  full_sweep: bool = False, visited=None):
    """A host-side (numpy) model of what kernel B2 evaluates on a layout
    after its two skips: returns (items, evaluations), the items (row chunk,
    column chunk of an enumerated tile pair) it runs and the pair
    evaluations it makes in them (columns kept by the vote, rounded up to
    its rounds of four, times 32 rows).  ``pos`` (n_pad, 3) are the
    layout's positions, ``real`` (n_pad,) bool its non-pad slots,
    ``marked`` the (n_chunks, n_chunks) bool matrix of its
    ``chunk_pair_map`` (None: no marked pair, the far mode).  An item runs
    when it is marked or the two chunk boxes come within the cutoff; in it
    a column is kept when the item is marked or the column lies within the
    cutoff of the row chunk's box.  ``visited``, an (n_pad, n_pad) bool
    array, is filled with the (row, column) pairs evaluated (small systems:
    the tests hold it against the pairs that must not be dropped).
    ``ForceEvaluator`` costs its band tile sizes with it."""
    pos = np.asarray(pos, np.float64)
    box = np.asarray(box, np.float64).reshape(3)
    real = np.asarray(real, bool)
    n_pad = pos.shape[0]
    nrc = ts // 32
    mid, half, any_, _ = _chunk_boxes_np(pos, real, box)
    rc2 = r_cutoff * r_cutoff * 1.0001
    ti, tj = tile_pairs(mode, n_pad // ts, band_w, full_sweep)
    chunk = np.arange(nrc)
    items = evaluations = 0
    cols = pos.reshape(-1, 32, 3)
    for i in np.unique(ti):
        cg = (tj[ti == i][:, None] * nrc + chunk).reshape(-1)  # col chunks
        for rg in i * nrc + chunk:
            u = mid[cg] - mid[rg]
            u -= box * np.round(u / box)
            gap = np.maximum(np.abs(u) - half[rg] - half[cg], 0.0)
            mk = marked[rg, cg] if marked is not None \
                else np.zeros(cg.shape, bool)
            run = mk | (any_[cg] & any_[rg] & ((gap * gap).sum(-1) <= rc2))
            c_run, m_run = cg[run], mk[run]
            items += int(run.sum())
            v = cols[c_run] - mid[rg]
            v -= box * np.round(v / box)
            g = np.maximum(np.abs(v) - half[rg], 0.0)
            keep = (m_run[:, None] | ((g * g).sum(-1) <= rc2)) \
                & real.reshape(-1, 32)[c_run]
            evaluations += int((-(-keep.sum(axis=1) // 4) * 4).sum()) * 32
            if visited is not None:
                col_idx = (c_run[:, None] * 32 + np.arange(32))[keep]
                visited[rg * 32:(rg + 1) * 32, col_idx] = True
    return items, evaluations


def band_layout_np(pos, box, ts: int, inner_order: bool = True):
    """Host-side (numpy) mirror of ``make_pair_cache``'s layout: the
    (n_pad,) slot -> atom order (pads are n .. n_pad - 1), with the keys
    taken in float32 as on the device."""
    p32 = np.asarray(pos, np.float32)
    b32 = np.asarray(box, np.float32).reshape(3)
    n = p32.shape[0]
    n_pad = padded_size(n, ts)
    zw = p32[:, 2] - b32[2] * np.floor(p32[:, 2] / b32[2])
    keys = np.concatenate([zw, np.full(n_pad - n, 1e30, np.float32)])
    order = np.argsort(keys, kind="stable")
    if inner_order:
        w = p32[:, :2] - b32[:2] * np.floor(p32[:, :2] / b32[:2])
        w = np.concatenate([w, np.full((n_pad - n, 2), 1e30, np.float32)])
        slot = np.arange(n_pad)
        strip = slot // ts * inner_strips(ts) \
            + slot % ts // (ts // inner_strips(ts))
        for axis, group in ((0, slot // ts), (1, strip)):
            by_coord = np.argsort(w[order, axis], kind="stable")
            order = order[by_coord[np.argsort(group[by_coord],
                                              kind="stable")]]
    return order


def _launcher():
    """The kernel library with its C signature declared (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = kernels.load("tri_pair")
    if lib.tri_pair_launch.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tri_pair_launch.argtypes = (
            [P, P, P, I, I, P, P, P, I, P, P, P, P, P] + [I] * 13
            + [F] * 6 + [ctypes.POINTER(F)] + [P] * 8)
        lib.tri_pair_launch.restype = I
        lib.tri_pair_error_string.argtypes = [I]
        lib.tri_pair_error_string.restype = ctypes.c_char_p
    return lib


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"tri_pair: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def tri_pair(pos, q, ab, bits, bits14, oid, ljt, grp, grows, box, *, ts,
             t_dim, beta, r_cutoff, mode, band_w=0, full_sweep=False,
             want_energy=True, has14=False, r_switch=0.0, row_off=0,
             n_tiles_g=0, n_row_tiles=0, cmap=None, evals=None):
    """One tile-pair enumeration of the upper-triangle sweep: returns
    (rows (n_pad, 8), colacc (8, n_pad)).

    On a CUDA tensor this launches kernel B2 (``csrc/tri_pair.cu``) on the
    current stream and counts the launch in ``tri_pair.launches``; on a
    CPU tensor it runs ``tri_pair_reference``.  There is no fallback: a
    CUDA call the kernel cannot take raises.  ``ts`` is a multiple of 32 up
    to 768.

    The row-sharded form (``bandall`` only, the JAX ``row_off`` /
    ``n_tiles_g``): the call's rows are the ``n_row_tiles`` tiles from
    global tile ``row_off`` on (0: all the rest), the column tile wraps on
    the ring of ``n_tiles_g`` tiles (0: all), the dedup guard and the
    diagonal go by the global row tile; every input stays full-length, rows
    comes back ``(n_row_tiles * ts, 8)`` and colacc full-length, to be
    summed over the shards.

    ``cmap`` is the layout's ``chunk_pair_map`` (a cache or
    ``band_statics`` carries it; built here from the masks when not given;
    unused in the ``far`` mode and on the CPU).  ``evals``, a one-element
    int64 CUDA tensor, has the kernel add the pair evaluations it makes
    after its column skip (a measurement aid; the CPU version ignores it)."""
    kw = dict(ts=ts, t_dim=t_dim, beta=beta, r_cutoff=r_cutoff, mode=mode,
              band_w=band_w, full_sweep=full_sweep, want_energy=want_energy,
              has14=has14, r_switch=r_switch, row_off=row_off,
              n_tiles_g=n_tiles_g, n_row_tiles=n_row_tiles)
    dev = pos.device
    if dev.type == "cpu":
        return tri_pair_reference(pos, q, ab, bits, bits14, oid, ljt, grp,
                                  grows, box, **kw)
    if dev.type != "cuda":
        raise ValueError(f"tri_pair: unsupported device {dev}")
    if mode not in MODES:
        raise ValueError(f"tri_pair: unknown mode {mode!r}")
    if ts % 32 or not 32 <= ts <= 768:
        raise ValueError(f"tri_pair: ts must be a multiple of 32 in "
                         f"[32, 768], got {ts}")
    n_pad = pos.shape[0]
    if n_pad % ts:
        raise ValueError(f"tri_pair: {n_pad} atoms is not a whole number "
                         f"of {ts}-atom tiles")
    n_tiles = n_pad // ts
    n_rt = _row_tiles(mode, n_tiles, row_off, n_tiles_g, n_row_tiles)
    if mode == "bandall" and not 0 <= band_w < max(n_tiles_g or n_tiles, 1):
        raise ValueError(f"tri_pair: band_w {band_w} out of range for "
                         f"{n_tiles_g or n_tiles} tiles")
    i32, f32 = torch.int32, torch.float32
    ab_w = (4 if has14 else 2) * t_dim
    _check(pos, "pos", f32, (n_pad, 3), dev)
    _check(q, "q", f32, (n_pad,), dev)
    if ab.shape[1] < ab_w:
        raise ValueError(f"tri_pair: ab needs {ab_w} columns (has14="
                         f"{has14}), got {ab.shape[1]}")
    _check(ab, "ab", f32, (n_pad, ab.shape[1]), dev)
    for name, t in (("bits", bits), ("bits14", bits14), ("oid", oid),
                    ("ljt", ljt), ("grp", grp)):
        _check(t, name, i32, (n_pad,), dev)
    if grows is not None:
        _check(grows, "grows", f32, (n_pad, grows.shape[1]), dev)
    _check(box, "box", f32, (3,), dev)
    n_chunks = n_pad // 32
    if mode == "far":
        cmap = None
    elif cmap is None:
        cmap = chunk_pair_map(bits | bits14 if has14 else bits,
                              None if mode == "band" else oid)
    if cmap is not None:
        _check(cmap, "cmap", i32, (n_chunks, -(-n_chunks // 32)), dev)
    if evals is not None:
        _check(evals, "evals", torch.int64, (1,), dev)
    sc = _kernel_scalars(beta, r_cutoff)
    _, n_items, splits, per = tri_tiling(mode, ts, n_tiles, band_w)
    n_row_chunks = n_rt * (ts // 32)
    rows = torch.empty((n_rt * ts, 8), dtype=f32, device=dev)
    colacc = torch.empty((8, n_pad), dtype=f32, device=dev)
    cbox = torch.empty((n_chunks, 8), dtype=f32, device=dev)
    prow = torch.empty((n_row_chunks * splits, 8, 32), dtype=f32, device=dev)
    pcol = torch.empty((n_row_chunks * n_items, 3, 32), dtype=f32,
                       device=dev)
    iflag = torch.empty(n_row_chunks * n_items, dtype=torch.uint8,
                        device=dev)
    pcoef = (ctypes.c_float * len(sc["pcoef"]))(*sc["pcoef"])
    lib = _launcher()
    err = lib.tri_pair_launch(
        pos.data_ptr(), q.data_ptr(), ab.data_ptr(), ab.shape[1], t_dim,
        ljt.data_ptr(), grp.data_ptr(),
        None if grows is None else grows.data_ptr(),
        0 if grows is None else grows.shape[1], bits.data_ptr(),
        bits14.data_ptr(), oid.data_ptr(), box.data_ptr(),
        None if cmap is None else cmap.data_ptr(),
        0 if cmap is None else cmap.shape[1], n_pad, ts,
        MODES.index(mode), int(band_w), int(bool(full_sweep)),
        int(bool(want_energy)), int(bool(has14)), int(row_off),
        int(n_tiles_g), n_rt, splits, per, float(beta), sc["rc2"],
        float(r_cutoff), float(r_switch), _CAP3, sc["gauss_pref"], pcoef,
        cbox.data_ptr(), prow.data_ptr(), pcol.data_ptr(), iflag.data_ptr(),
        rows.data_ptr(), colacc.data_ptr(),
        None if evals is None else evals.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("tri_pair kernel launch failed: "
                           + lib.tri_pair_error_string(err).decode())
    tri_pair.launches += 1
    return rows, colacc


tri_pair.launches = 0


def run_tri(pos, q, ab, bits, bits14, oid, ljt, grp, grows, box, *, ts,
            t_dim, beta, r_cutoff, has14, band_w=0, want_energy=True,
            full_sweep=False, r_switch=0.0, cmap=None):
    """The dispatch of the JAX ``_run_tri``: the full sweep
    (``bandall`` with band_w = n_tiles // 2) when ``full_sweep``, else
    ``bandall`` at ``band_w`` when the band is eligible, else ``band`` +
    ``far``."""
    n_tiles = pos.shape[0] // ts
    args = (pos, q, ab, bits, bits14, oid, ljt, grp, grows, box)
    kw = dict(ts=ts, t_dim=t_dim, beta=beta, r_cutoff=r_cutoff,
              want_energy=want_energy, has14=has14, r_switch=r_switch,
              cmap=cmap)
    if full_sweep:
        return tri_pair(*args, mode="bandall", band_w=n_tiles // 2,
                        full_sweep=True, **kw)
    if band_eligible(pos.shape[0], ts, band_w):
        return tri_pair(*args, mode="bandall", band_w=band_w, **kw)
    rows, colacc = tri_pair(*args, mode="band", **kw)
    if n_tiles > 2:
        rows_f, col_f = tri_pair(*args, mode="far", **kw)
        rows = rows + rows_f
        colacc = colacc + col_f
    return rows, colacc


def direct_space_band(pos, box, charges, tables, beta, r_cutoff, ts: int,
                      band_w: int, want_energy: bool = True,
                      cache: Optional[BandCache] = None,
                      r_switch: float = 0.0, strict: bool = False,
                      statics=None):
    """The symmetric band branch of the JAX ``direct_space_pallas``.
    Returns (e_lj, e_coul, e_corr, e14_coul, e14_lj, forces,
    coverage_bad), with the folded 1-4 energies filled in when the tables
    carry them.

    When the band is eligible the sweep runs on the z-sorted layout
    (``cache``, built here when None) and ``band_coverage_bad`` is taken on
    the current positions; ``strict=True`` reads that flag on the host (the
    step's one synchronisation) and takes the full sweep when it is set,
    returning it as a Python bool.  Otherwise the unsorted band + far sweep
    runs and the flag is False."""
    dev = pos.device
    box = box.reshape(3)
    n = pos.shape[0]
    n_pad = padded_size(n, ts)
    t_dim = tables["arows"].shape[1]
    has14 = bool(tables.get("has_exc14", False))
    pos2d = torch.cat([pos, torch.full((n_pad - n, 3), 1e6,
                                       dtype=torch.float32, device=dev)])
    use_band = band_eligible(n_pad, ts, band_w)
    if use_band:
        if cache is None:
            cache = make_pair_cache(pos, box, charges, tables, ts,
                                    statics=statics, inner_order=True)
        f = cache
        pos2d = pos2d[cache.perm]
        flag = band_coverage_bad(pos, box, cache, ts, band_w, r_cutoff)
        if strict:
            flag = bool(flag)
        full = strict and flag
        oid = cache.oid
    else:
        if statics is None or statics["q"].shape[0] != n_pad:
            statics = band_statics(charges, tables, n_pad, dev)
        f = BandCache(perm=None, invperm=None, oid=None, **statics)
        oid = torch.arange(n_pad, dtype=torch.int32, device=dev)
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        full = False
    rows, colacc = run_tri(
        pos2d, f.q, f.ab, f.bits, f.bits14, oid, f.ljt, f.grp, f.grows, box,
        ts=ts, t_dim=t_dim, beta=beta, r_cutoff=r_cutoff, has14=has14,
        band_w=band_w if use_band else 0, want_energy=want_energy,
        full_sweep=full, r_switch=r_switch, cmap=f.cmap)
    if use_band:
        forces = (rows[:, :3] + colacc[:3, :].t())[cache.invperm][:n]
    else:
        forces = rows[:n, :3] + colacc[:3, :n].t()
    e = [torch.sum(rows[:, c]) for c in range(3, 8)]
    e_lj, e_coul, e_corr, forces = residual_adjustment(
        pos, box, charges, tables, beta, r_cutoff, e[0], e[1], e[2], forces,
        r_switch=r_switch)
    return e_lj, e_coul, e_corr, e[3], e[4], forces, flag
