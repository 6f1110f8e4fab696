"""The hand-written kernels against their plain torch versions on the card:
B1 (csrc/plist_pair.cu) for the tile sizes from one warp (32) to 384, both
specializations, the nowrap and wrapped frames, the LJ rows in shared
memory or read through __ldg, and on a constant-voltage image slab (group
rows, image-image tile pairs culled); B2 (csrc/tri_pair.cu) in every tile-pair
enumeration x specialization x 1-4 folding x interaction groups on the
layout the evaluator builds, at tile sizes 32 to 768, and in its row-sharded
form; B4/B5
(csrc/ewald_fused.cu) forward, backward and through autograd, B4 also
with its nz groups cut over grid.z (a tall cell's kmax[2] of 97); B3
(csrc/rect_pair.cu) at two tile shapes with and without interaction groups,
with excluded pairs beyond the cutoff, in a tall box, on positions moved by
whole box lengths and at n % 32 != 0, its evaluations against the torch
model of its skips; B6-B8 (csrc/gather.cu) bitwise against their plain
versions and against torch.index_select, B7 also with indices out of range,
m % 4 != 0 and unaligned indices; the constraint-cluster kernels
(csrc/constraint_clusters.cu), SHAKE and RATTLE, on rigid SWM4-NDP waters
at the water cells' 3,900, CH3 and CH4 stars, K = 1 and K = 2 buckets,
five buckets in one system and clusters straddling the box faces.  A CUDA
kernel has no CPU mode, so these tests skip on a machine without a card;
chip_smoke.py runs the same comparisons at the main path's shapes.

Tolerance: rsqrtf is ~2 ulp from torch.rsqrt and nvcc contracts
multiply-adds, so a pair kernel and its plain version agree to float32
rounding; the bounds are the JAX package's pair-sweep tolerances
(tests/test_pallas.py:105-107, 179-182, 397-400) and fused-reciprocal
tolerances (tests/test_ewald_fused.py:36, 52-53).  The constraint kernels
repeat their plain version's formulas, with fma contraction: rows within
chip_smoke.CC_ULPS float32 epsilons of the largest entry, residuals at or
below the plain version's to the rounding of the rows
(chip_smoke.constraint_agreement)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
from openmm_velocityverlet_tpu_torch.ops import (allpairs, constraints,
                                                 ewald, ewald_fused,
                                                 pair_plist, pair_rect,
                                                 pair_tri)
from openmm_velocityverlet_tpu_torch.tools import exp_gather_kernel as gtool
from openmm_velocityverlet_tpu_torch.units import ONE_4PI_EPS0

pytestmark = pytest.mark.cuda


def _sibling(name):
    """A test module beside this one, loaded by path: on the card's machine
    another installed package answers to ``tests``."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


rect_cull = _sibling("test_torch_rect_cull")

BETA, RC = 2.2, 1.2


def _grid_mol_system(rng, nx=4, ny=4, nz=24, lz=12.0, apm=4, n_types=3):
    """Molecules of ``apm`` mutually excluded atoms on a jittered grid in a
    tall box (the layout of tests/test_pallas.py:_grid_mol_system, built
    here without jax: the card's machine has none)."""
    n = nx * ny * nz * apm
    lj_type = rng.integers(0, n_types, n)
    sig = rng.uniform(0.25, 0.4, n_types)
    eps = rng.uniform(0.1, 1.0, n_types)
    a = np.sqrt(np.outer(eps, eps)) ** 0.5 * np.outer(sig, sig) ** 3 * 2.0
    b = 2.0 * np.sqrt(np.outer(eps, eps)) * np.outer(sig, sig) ** 3 * 2.0
    box = np.array([3.0, 3.0, lz], np.float32)
    grid = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                indexing="ij"), -1).reshape(-1, 3)
    centers = (grid + 0.5) * box / (nx, ny, nz) \
        + rng.uniform(-0.06, 0.06, grid.shape)
    pos = np.repeat(centers, apm, 0) + rng.normal(0, 0.04, (n, 3))
    excl = np.full((n, apm - 1), -1, np.int64)
    for i in range(n):
        base = i - i % apm
        for j in range(i + 1, base + apm):
            excl[i, j - i - 1] = j
    q = rng.normal(0, 0.5, n)
    return lj_type, a, b, excl, pos, box, q


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _setup(dev, ts, groups, nowrap, n_types=3):
    rng = np.random.default_rng(11)
    lj_type, a, b, excl, pos, box, q = _grid_mol_system(rng, n_types=n_types)
    n = len(lj_type)
    lj_group = rng.integers(0, 2, n) if groups else None
    allowed = np.array([[True, True], [True, False]]) if groups else None
    tables = allpairs.build_pair_tables(n, lj_type, a, b, excl, lj_group,
                                        allowed, fold_exc14=False)
    nw = pair_plist.nowrap_axes_np(pos, box, ts, RC + 0.1, mode="z") \
        if nowrap else (False, False, False)
    cnt = pair_plist.count_candidates_np(pos, box, ts, RC + 0.1, mode="z")
    posd = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    boxd = torch.as_tensor(box, dtype=torch.float32, device=dev)
    cache = pair_plist.make_pair_cache(
        posd, boxd, q, tables, ts, mode="z", cap=int(cnt * 1.6) + 16,
        rc_cand=RC + 0.1, nowrap=nw)
    pad = cache.perm.shape[0] - n
    pos2d = torch.cat([posd, torch.full((pad, 3), 1e6, device=dev)]
                      )[cache.perm].contiguous()
    args = (cache.plist, cache.row_ptr, cache.col_ptr, cache.col_idx, pos2d,
            cache.q, cache.ab2, cache.ljt, cache.grp, cache.bits, cache.oid,
            boxd)
    kw = dict(ts=ts, t_dim=tables["arows"].shape[1], beta=BETA, r_cutoff=RC,
              nowrap=nw)
    return args, kw, (cache.blk_tile, cache.blk_e0, cache.blk_ptr)


def _plist_against_plain(dev, args, kw, blocks, want_energy):
    ts = kw["ts"]
    before = pair_plist.plist_pair.launches
    evals = torch.zeros(1, dtype=torch.int64, device=dev)
    rows, colacc = pair_plist.plist_pair(*args, want_energy=want_energy,
                                         blocks=blocks, evals=evals, **kw)
    assert pair_plist.plist_pair.launches == before + 1
    rows_p, col_p = pair_plist.plist_pair_reference(
        *args, want_energy=want_energy, **kw)
    torch.cuda.synchronize()
    # the column skip cuts the list's ts x ts slots, never to nothing
    slots = int((args[0] & 1).sum()) * ts * ts
    assert 0 < int(evals) <= slots + 3 * 32 * int((args[0] & 1).sum()) \
        * (ts // 32) ** 2
    np.testing.assert_allclose(rows[:, :3].cpu().numpy(),
                               rows_p[:, :3].cpu().numpy(),
                               rtol=1e-3, atol=5e-2)
    np.testing.assert_allclose(colacc.cpu().numpy(), col_p.cpu().numpy(),
                               rtol=1e-3, atol=5e-2)
    for c in (3, 4, 5):
        np.testing.assert_allclose(float(rows[:, c].double().sum()),
                                   float(rows_p[:, c].double().sum()),
                                   rtol=5e-5, atol=0.05)
    # the source documents B1 as bitwise deterministic run to run; without
    # ``blocks`` the wrapper cuts the same slices itself
    rows2, col2 = pair_plist.plist_pair(*args, want_energy=want_energy, **kw)
    assert torch.equal(rows, rows2) and torch.equal(colacc, col2)


@pytest.mark.parametrize("ts", [32, 64, 96, 128, 256, 384])
@pytest.mark.parametrize("want_energy", [False, True])
@pytest.mark.parametrize("groups,nowrap,r_switch", [
    (False, True, 0.0), (True, False, 0.0), (False, False, 0.9)])
def test_plist_kernel_matches_plain(cuda, ts, want_energy, groups, nowrap,
                                    r_switch):
    args, kw, blocks = _setup(cuda, ts, groups, nowrap)
    kw["r_switch"] = r_switch
    _plist_against_plain(cuda, args, kw, blocks, want_energy)


@pytest.mark.parametrize("ts,groups", [(384, False), (384, True), (32, True)])
def test_plist_kernel_many_lj_types(cuda, ts, groups):
    """40 LJ types: at ts = 384 the tile's LJ rows (384 x 41 [a, b] pairs,
    126 KB) do not fit the block's shared memory and that call reads them
    through __ldg; at ts = 32 they fit."""
    args, kw, blocks = _setup(cuda, ts, groups, False, n_types=40)
    for want_energy in (False, True):
        _plist_against_plain(cuda, args, kw, blocks, want_energy)


def _image_slab_setup(dev, ts):
    """A constant-voltage slab: two electrode layers (group 2), three-atom
    molecules of mutually excluded atoms above them (group 0) and a
    trailing block of their massless images mirrored across z = 4 with the
    negated charges and the molecules' exclusions (group 1), LJ groups
    [(0,0),(0,2),(2,2),(1,0)] (run-edl's), and the step's list with the
    image-image tile pairs culled."""
    rng = np.random.default_rng(13)
    box = np.array([3.0, 3.0, 8.0], np.float32)
    g = (np.stack(np.meshgrid(np.arange(10), np.arange(10), indexing="ij"),
                  -1).reshape(-1, 2) + 0.5) * 0.3
    elec = np.concatenate([np.c_[g, np.full(100, z)] for z in (0.1, 0.3)])
    n_mol = 320
    centers = (np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(5),
                                    indexing="ij"), -1).reshape(-1, 3) + 0.5
               ) * [0.375, 0.375, 0.6] + [0, 0, 0.6]
    liq = np.repeat(centers, 3, 0) + rng.normal(0, 0.05, (3 * n_mol, 3))
    img = liq * [1, 1, -1] + [0, 0, 8.0]
    pos = np.concatenate([elec, liq, img]).astype(np.float32)
    n_el, n_liq = len(elec), len(liq)
    n = len(pos)
    q = np.concatenate([np.zeros(n_el), rng.normal(0, 0.5, n_liq)])
    q = np.concatenate([q, -q[n_el:]])
    lj_type = np.concatenate([np.zeros(n_el, int),
                              rng.integers(1, 3, n_liq),
                              np.full(n_liq, 3)])
    sig = np.array([0.3, 0.32, 0.25, 0.1])
    eps = np.array([0.6, 0.5, 0.3, 0.0])
    a = np.sqrt(np.outer(eps, eps)) ** 0.5 * np.outer(sig, sig) ** 3 * 2.0
    b = 2.0 * np.sqrt(np.outer(eps, eps)) * np.outer(sig, sig) ** 3 * 2.0
    excl = np.full((n, 2), -1, np.int64)
    for base in (n_el, n_el + n_liq):
        for m in range(n_mol):
            i0 = base + 3 * m
            excl[i0] = (i0 + 1, i0 + 2)
            excl[i0 + 1, 0] = i0 + 2
    groups = np.concatenate([np.full(n_el, 2), np.zeros(n_liq, int),
                             np.ones(n_liq, int)])
    allowed = np.zeros((3, 3), bool)
    for gi, gj in [(0, 0), (0, 2), (2, 2), (1, 0)]:
        allowed[gi, gj] = allowed[gj, gi] = True
    tables = allpairs.build_pair_tables(n, lj_type, a, b, excl, groups,
                                        allowed, fold_exc14=False)
    inert = np.arange(n) >= n_el + n_liq
    cnt = pair_plist.count_candidates_np(pos, box, ts, RC + 0.1,
                                         mode="morton", inert=inert)
    posd = torch.as_tensor(pos, device=dev)
    boxd = torch.as_tensor(box, device=dev)
    cache = pair_plist.make_pair_cache(
        posd, boxd, q, tables, ts, mode="morton", cap=int(cnt * 1.6) + 16,
        rc_cand=RC + 0.1, inert=inert)
    assert cache.tile_inert.any() and not bool(cache.overflow)
    pad = cache.perm.shape[0] - n
    pos2d = torch.cat([posd, torch.full((pad, 3), 1e6, device=dev)]
                      )[cache.perm].contiguous()
    args = (cache.plist, cache.row_ptr, cache.col_ptr, cache.col_idx, pos2d,
            cache.q, cache.ab2, cache.ljt, cache.grp, cache.bits, cache.oid,
            boxd)
    assert cache.ab2.shape[0] == 3 * cache.perm.shape[0]   # group rows
    kw = dict(ts=ts, t_dim=tables["arows"].shape[1], beta=BETA, r_cutoff=RC)
    return args, kw, (cache.blk_tile, cache.blk_e0, cache.blk_ptr)


@pytest.mark.parametrize("want_energy", [False, True])
def test_plist_kernel_image_slab(cuda, want_energy):
    """B1 in its group-rows form (ab2 stacked 3 deep) on a list whose
    image-image tile pairs are culled, against its plain version."""
    args, kw, blocks = _image_slab_setup(cuda, 32)
    _plist_against_plain(cuda, args, kw, blocks, want_energy)


def test_plist_kernel_rejects_bad_input(cuda):
    args, kw, _ = _setup(cuda, 128, False, False)
    bad = list(args)
    bad[4] = args[4].double()
    with pytest.raises(ValueError, match="pos"):
        pair_plist.plist_pair(*bad, **kw)
    with pytest.raises(ValueError, match="ts"):
        pair_plist.plist_pair(*args, **dict(kw, ts=48))
    with pytest.raises(ValueError, match="blocks"):
        pair_plist.plist_pair(*args, blocks=(args[1], args[1], args[1]), **kw)


# ------------------------------------------------------------- kernel B2
def _tri_setup(dev, nz, groups, has14):
    """The grid molecular system in z-sorted tiles, with regular 1-4
    exceptions on (4m, 4m+3) folded into the tables when ``has14`` (the
    layout of tests/test_pallas.py:362-400)."""
    rng = np.random.default_rng(13)
    lj_type, a, b, excl, pos, box, q = _grid_mol_system(rng, nz=nz)
    n = len(lj_type)
    lj_group = rng.integers(0, 2, n) if groups else None
    allowed = np.array([[True, True], [True, False]]) if groups else None
    exc = {}
    if has14:
        idx = np.full((n, 1), -1, np.int32)
        qq = np.zeros((n, 1), np.float32)
        c6 = np.zeros((n, 1), np.float32)
        c12 = np.zeros((n, 1), np.float32)
        for m in range(n // 4):
            i, j = 4 * m, 4 * m + 3
            ti, tj = lj_type[i], lj_type[j]
            idx[i, 0], idx[j, 0] = j, i
            qq[i, 0] = qq[j, 0] = ONE_4PI_EPS0 * 0.5 * q[i] * q[j]
            c6[i, 0] = c6[j, 0] = 0.6 * b[ti, tj]
            c12[i, 0] = c12[j, 0] = (0.5 * a[ti, tj]) ** 2
        exc = dict(exc_idx=idx, exc_qq=qq, exc_c6=c6, exc_c12=c12, charges=q)
    tables = allpairs.build_pair_tables(n, lj_type, a, b, excl, lj_group,
                                        allowed, fold_exc14=has14, **exc)
    assert tables["has_exc14"] == has14
    posd = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    boxd = torch.as_tensor(box, dtype=torch.float32, device=dev)
    return tables, posd, boxd, q


# (enumerations, tile size, z-sorted layout): bandall at W = 3; band + far
# on the unsorted layout; the full sweep with an odd (11) and an even (12)
# tile count, the latter taking the dedup guard at offset n_tiles / 2,
# which shows only on the unsorted layout (z-sorted tiles at that offset
# lie half a box apart and never interact)
TRI_CASES = {
    "bandall": ([("bandall", 3, False)], 128, 24, True),
    "band+far": ([("band", 0, False), ("far", 0, False)], 128, 24, False),
    "full_odd": ([("bandall", 5, True)], 128, 22, True),
    "full_even": ([("bandall", 6, True)], 128, 24, True),
    "full_even_unsorted": ([("bandall", 6, True)], 128, 24, False),
    "bandall_640": ([("bandall", 1, False)], 640, 30, True),
    "bandall_256": ([("bandall", 2, False)], 256, 24, True),
    "bandall_768": ([("bandall", 1, False)], 768, 36, True),
    "full_32": ([("bandall", 12, True)], 32, 12, True),
}


@pytest.mark.parametrize("case", sorted(TRI_CASES))
@pytest.mark.parametrize("want_energy", [False, True])
@pytest.mark.parametrize("has14,groups", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_tri_kernel_matches_plain(cuda, case, want_energy, has14, groups):
    enums, ts, nz, z_sorted = TRI_CASES[case]
    tables, posd, boxd, q = _tri_setup(cuda, nz, groups, has14)
    n = posd.shape[0]
    n_pad = pair_tri.padded_size(n, ts)
    st = pair_tri.band_statics(q, tables, n_pad, cuda)
    if z_sorted:
        # the layout the evaluator builds: strips inside each z-sorted tile
        f = pair_tri.make_pair_cache(posd, boxd, q, tables, ts, statics=st,
                                     inner_order=True)
        oid = f.oid
    else:
        f = pair_tri.BandCache(perm=torch.arange(n_pad, device=cuda),
                               invperm=None, oid=None, **st)
        oid = torch.arange(n_pad, dtype=torch.int32, device=cuda)
    pos2d = torch.cat([posd, torch.full((n_pad - n, 3), 1e6, device=cuda)]
                      )[f.perm].contiguous()
    args = (pos2d, f.q, f.ab, f.bits, f.bits14, oid, f.ljt, f.grp, f.grows,
            boxd)
    for mode, band_w, full in enums:
        kw = dict(ts=ts, t_dim=tables["arows"].shape[1], beta=BETA,
                  r_cutoff=RC, mode=mode, band_w=band_w, full_sweep=full,
                  want_energy=want_energy, has14=has14)
        if full:
            assert kw["band_w"] == (n_pad // ts) // 2
        before = pair_tri.tri_pair.launches
        evals = torch.zeros(1, dtype=torch.int64, device=cuda)
        rows, colacc = pair_tri.tri_pair(*args, cmap=f.cmap, evals=evals,
                                         **kw)
        assert pair_tri.tri_pair.launches == before + 1
        rows_p, col_p = pair_tri.tri_pair_reference(*args, **kw)
        torch.cuda.synchronize()
        # the skips cut the enumeration's ts x ts slots, never to nothing
        slots = len(pair_tri.tile_pairs(mode, n_pad // ts, band_w, full)[0]) \
            * ts * ts
        assert 0 < int(evals) <= slots
        if z_sorted and mode == "bandall" and ts >= 128:
            assert int(evals) < 0.9 * slots
        np.testing.assert_allclose(rows[:, :3].cpu().numpy(),
                                   rows_p[:, :3].cpu().numpy(),
                                   rtol=1e-3, atol=5e-2, err_msg=mode)
        np.testing.assert_allclose(colacc.cpu().numpy(),
                                   col_p.cpu().numpy(), rtol=1e-3,
                                   atol=5e-2, err_msg=mode)
        e_rtol, e_atol = (5e-5, 1e-3) if has14 else (2e-5, 0.0)
        for c in range(3, 8):
            np.testing.assert_allclose(float(rows[:, c].double().sum()),
                                       float(rows_p[:, c].double().sum()),
                                       rtol=e_rtol, atol=e_atol + 1e-6,
                                       err_msg=f"{mode} column {c}")
        # bitwise run to run; without ``cmap`` the wrapper builds the same
        rows2, col2 = pair_tri.tri_pair(*args, **kw)
        assert torch.equal(rows, rows2) and torch.equal(colacc, col2)


@pytest.mark.parametrize("ts,nz,band_w,full", [(128, 24, 3, False),
                                               (128, 24, 6, True),
                                               (128, 22, 5, True),
                                               (256, 24, 2, False)])
@pytest.mark.parametrize("want_energy", [False, True])
def test_tri_kernel_row_sharded(cuda, ts, nz, band_w, full, want_energy):
    """The row-sharded form on the card: each half of the row tiles against
    the plain version of the same call, the halves' rows equal to the
    unsharded call's bitwise (a row chunk's items and their order are the
    same) and their column accumulators adding up to it."""
    tables, posd, boxd, q = _tri_setup(cuda, nz, True, True)
    f = pair_tri.make_pair_cache(posd, boxd, q, tables, ts, inner_order=True)
    n_pad = f.perm.shape[0]
    pos2d = torch.cat([posd, torch.full((n_pad - posd.shape[0], 3), 1e6,
                                        device=cuda)])[f.perm].contiguous()
    args = (pos2d, f.q, f.ab, f.bits, f.bits14, f.oid, f.ljt, f.grp, f.grows,
            boxd)
    n_tiles = n_pad // ts
    kw = dict(ts=ts, t_dim=tables["arows"].shape[1], beta=BETA, r_cutoff=RC,
              mode="bandall", band_w=band_w, full_sweep=full,
              want_energy=want_energy, has14=True, cmap=f.cmap)
    rows, colacc = pair_tri.tri_pair(*args, **kw)
    h = n_tiles // 2
    parts = []
    for off, cnt in ((0, h), (h, n_tiles - h)):
        skw = dict(kw, row_off=off, n_row_tiles=cnt, n_tiles_g=n_tiles)
        r, c = pair_tri.tri_pair(*args, **skw)
        del skw["cmap"]
        r_p, c_p = pair_tri.tri_pair_reference(*args, **skw)
        assert r.shape == r_p.shape == (cnt * ts, 8)
        np.testing.assert_allclose(r[:, :3].cpu().numpy(),
                                   r_p[:, :3].cpu().numpy(), rtol=1e-3,
                                   atol=5e-2)
        np.testing.assert_allclose(c.cpu().numpy(), c_p.cpu().numpy(),
                                   rtol=1e-3, atol=5e-2)
        for k in range(3, 8):
            np.testing.assert_allclose(float(r[:, k].double().sum()),
                                       float(r_p[:, k].double().sum()),
                                       rtol=5e-5, atol=1e-3 + 1e-6)
        parts.append((r, c))
    assert torch.equal(torch.cat([parts[0][0], parts[1][0]]), rows)
    np.testing.assert_allclose((parts[0][1] + parts[1][1]).cpu().numpy(),
                               colacc.cpu().numpy(), rtol=1e-3, atol=5e-2)


def test_tri_kernel_rejects_bad_input(cuda):
    tables, posd, boxd, q = _tri_setup(cuda, 24, False, False)
    f = pair_tri.make_pair_cache(posd, boxd, q, tables, 128)
    pos2d = torch.cat([posd, torch.zeros((f.q.shape[0] - posd.shape[0], 3),
                                         device=cuda)])[f.perm].contiguous()
    args = [pos2d, f.q, f.ab, f.bits, f.bits14, f.oid, f.ljt, f.grp, None,
            boxd]
    kw = dict(ts=128, t_dim=tables["arows"].shape[1], beta=BETA, r_cutoff=RC,
              mode="bandall", band_w=3)
    for k, bad in ((0, pos2d.double()), (1, f.q.cpu()), (3, f.bits[:-1])):
        wrong = list(args)
        wrong[k] = bad
        with pytest.raises(ValueError):
            pair_tri.tri_pair(*wrong, **kw)
    with pytest.raises(ValueError, match="ts"):
        pair_tri.tri_pair(*args, **dict(kw, ts=100))
    with pytest.raises(ValueError, match="band_w"):
        pair_tri.tri_pair(*args, **dict(kw, band_w=12))
    with pytest.raises(ValueError, match="cmap"):
        pair_tri.tri_pair(*args, cmap=f.cmap[:, :0].contiguous(), **kw)
    with pytest.raises(ValueError, match="cmap"):
        pair_tri.tri_pair(*args, cmap=f.cmap.long(), **kw)
    with pytest.raises(ValueError, match="row"):
        pair_tri.tri_pair(*args, row_off=8, n_row_tiles=8, **kw)
    with pytest.raises(ValueError, match="bandall"):
        pair_tri.tri_pair(*args, **dict(kw, mode="band", row_off=1))
    with pytest.raises(ValueError, match="evals"):
        pair_tri.tri_pair(*args, evals=torch.zeros(1, device=cuda), **kw)


# ---------------------------------------------------------- kernels B4/B5
def _recip_system(dev, n, seed):
    rng = np.random.default_rng(seed)
    box = np.array([2.1, 2.6, 3.4])
    pos = rng.uniform(0, 1, (n, 3)) * box
    q = rng.normal(0, 1, n)
    q -= q.mean()
    return (torch.as_tensor(pos, dtype=torch.float32, device=dev),
            torch.as_tensor(box, dtype=torch.float32, device=dev),
            torch.as_tensor(q, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("n,kmax,ts", [(97, (3, 4, 6), 32),
                                       (3001, (9, 8, 10), 256),
                                       (700, (20, 20, 20), 256),
                                       (130, (0, 2, 1), 32),
                                       (130, (5, 0, 0), 32),
                                       (530, (2, 3, 30), 32),
                                       (61, (12, 11, 13), 8),
                                       (300, (11, 19, 97), 32)])
def test_fused_kernels_match_plain(cuda, n, kmax, ts):
    """B4 and B5 against their plain versions; the last case has the
    kmax of chip_smoke's EDL cell, whose 14 nz groups B4 cuts over grid.z."""
    pos, box, q = _recip_system(cuda, n, 21)
    posp, qp, kvec, w, c0, _, kp, _ = ewald_fused._prep(pos, box, q, 2.8,
                                                        kmax, ts)
    b4 = ewald_fused.structure_factor.launches
    s_re, s_im = ewald_fused.structure_factor(posp, qp, kvec, kmax, box)
    assert ewald_fused.structure_factor.launches == b4 + 1
    r_re, r_im = ewald_fused.structure_factor_reference(posp, qp, kvec)
    # every mode, the pad modes k >= K included (sum_i q_i in both), within
    # float32 rounding of the sum's size
    scale_s = float(qp.abs().sum())
    np.testing.assert_allclose(s_re.cpu().numpy(), r_re.cpu().numpy(),
                               atol=2e-5 * scale_s, rtol=0)
    np.testing.assert_allclose(s_im.cpu().numpy(), r_im.cpu().numpy(),
                               atol=2e-5 * scale_s, rtol=0)
    e_k = float(c0 * torch.sum(w * (s_re * s_re + s_im * s_im)))
    e_p = float(c0 * torch.sum(w * (r_re * r_re + r_im * r_im)))
    np.testing.assert_allclose(e_k, e_p, rtol=2e-5)
    ab = torch.stack([2.0 * c0 * w * s_im, 2.0 * c0 * w * s_re]).contiguous()
    b5 = ewald_fused.recip_forces.launches
    f = ewald_fused.recip_forces(posp, qp, kvec, ab, kmax, box)
    assert ewald_fused.recip_forces.launches == b5 + 1
    f_p = ewald_fused.recip_forces_reference(posp, qp, kvec, ab)
    scale = float(f_p.abs().max())
    np.testing.assert_allclose(f.cpu().numpy(), f_p.cpu().numpy(),
                               atol=3e-5 * scale, rtol=2e-4)
    again = ewald_fused.structure_factor(posp, qp, kvec, kmax, box)
    f2 = ewald_fused.recip_forces(posp, qp, kvec, ab, kmax, box)
    assert torch.equal(again[0], s_re) and torch.equal(again[1], s_im)
    assert torch.equal(f2, f)


def test_fused_autograd_matches_matmul_route(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    pos, box, q = _recip_system(cuda, 2000, 22)
    kmax = (9, 8, 10)
    p1 = pos.clone().requires_grad_(True)
    e_f = ewald_fused.reciprocal_energy_fused(p1, box, q, 2.8, kmax)
    (g_f,) = torch.autograd.grad(e_f, p1)
    p2 = pos.clone().requires_grad_(True)
    e_m = ewald.reciprocal_energy(p2, box, q, 2.8, kmax)
    (g_m,) = torch.autograd.grad(e_m, p2)
    np.testing.assert_allclose(float(e_f), float(e_m), rtol=2e-5)
    scale = float(g_m.abs().max())
    np.testing.assert_allclose(g_f.cpu().numpy(), g_m.cpu().numpy(),
                               atol=3e-5 * scale, rtol=2e-4)


def test_fused_kernels_reject_bad_input(cuda):
    pos, box, q = _recip_system(cuda, 97, 23)
    posp, qp, kvec, w, c0, _, kp, _ = ewald_fused._prep(pos, box, q, 2.8,
                                                        (3, 4, 6), 32)
    with pytest.raises(ValueError, match="posp"):
        ewald_fused.structure_factor(posp.double(), qp, kvec, (3, 4, 6), box)
    with pytest.raises(ValueError, match="qp"):
        ewald_fused.structure_factor(posp, qp.cpu(), kvec, (3, 4, 6), box)
    with pytest.raises(ValueError, match="kmax"):
        ewald_fused.structure_factor(posp, qp, kvec, (30, 4, 6), box)
    with pytest.raises(ValueError, match="box"):
        ewald_fused.structure_factor(posp, qp, kvec, (3, 4, 6), box.cpu())
    with pytest.raises(ValueError, match="ab"):
        ewald_fused.recip_forces(posp, qp, kvec, torch.zeros(
            (2, kp - 1), device=cuda), (3, 4, 6), box)
    with pytest.raises(ValueError, match="kmax"):
        ewald_fused.recip_forces(posp, qp, kvec, torch.zeros(
            (2, kp), device=cuda), (30, 4, 6), box)
    with pytest.raises(ValueError, match="device"):
        ewald_fused.structure_factor(posp.to("meta"), qp.to("meta"),
                                     kvec.to("meta"), (3, 4, 6), box)


# ------------------------------------------------------------- kernel B3
def _rect_setup(dev, blk, groups, r_switch=0.0):
    """The grid molecular system (23 layers: 1,472 atoms, so both tile
    shapes pad) in the unsorted layout padded to ``blk``, with each
    molecule's atoms on a tetrahedron of 0.06 nm radius: B3 has only the
    energy form, whose excluded-pair force cancels in float32 as r -> 0
    (ROADMAP C; 0.4 kJ/mol/nm of rounding at ~0.01 nm in the plain version
    alone, against float64), so near-coincident members would compare
    rounding noise."""
    rng = np.random.default_rng(17)
    lj_type, a, b, excl, pos, box, q = _grid_mol_system(rng, nz=23, lz=11.5)
    n = len(lj_type)
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                   np.float64) * (0.06 / np.sqrt(3.0))
    centers = pos.reshape(-1, 4, 3).mean(axis=1)
    pos = (centers[:, None, :] + tet[None]).reshape(-1, 3) \
        + rng.normal(0, 0.005, (n, 3))
    lj_group = rng.integers(0, 2, n) if groups else None
    allowed = np.array([[True, True], [True, False]]) if groups else None
    tables = allpairs.build_pair_tables(n, lj_type, a, b, excl, lj_group,
                                        allowed, fold_exc14=False)
    n_pad = pair_tri.padded_size(n, blk)
    st = pair_tri.band_statics(q, tables, n_pad, dev)
    pos2d = torch.cat([torch.as_tensor(pos, dtype=torch.float32, device=dev),
                       torch.full((n_pad - n, 3), 1e6, device=dev)])
    args = (pos2d.contiguous(), st["q"], st["ab"], st["bits"], st["ljt"],
            st["grp"], st["grows"],
            torch.as_tensor(box, dtype=torch.float32, device=dev))
    kw = dict(n=n, t_dim=tables["arows"].shape[1], beta=BETA, r_cutoff=RC,
              r_switch=r_switch)
    return args, kw


@pytest.mark.parametrize("system,tm,tn,groups,r_switch", [
    ("grid", 128, 128, False, 0.0), ("grid", 256, 512, False, 0.0),
    ("grid", 128, 128, True, 0.9), ("grid", 256, 512, True, 0.9),
    ("stretched_exclusions", 128, 128, False, 0.0),
    ("tall_box", 128, 128, False, 0.0), ("unwrapped", 256, 512, False, 0.0),
    ("n_not_multiple_of_32", 128, 128, True, 0.9)])
def test_rect_kernel_matches_plain(cuda, system, tm, tn, groups, r_switch):
    """B3 against its plain version: the grid system at two tile shapes,
    with and without groups and the switch, and the systems of
    tests/test_torch_rect_cull.py (excluded pairs beyond the cutoff, a tall
    box, positions moved by whole box lengths, n % 32 != 0); bitwise over
    runs, zero pad rows, and fewer evaluations than the first design's
    n_pad^2, as the torch model of its skips counts them."""
    if system == "grid":
        args, kw = _rect_setup(cuda, max(tm, tn), groups, r_switch)
    else:
        dims, spacing, drop, opts = rect_cull.CASES[system]
        args, kw = rect_cull.rect_system(dims, spacing, drop, **opts,
                                         blk=max(tm, tn), device=cuda)
    assert args[0].shape[0] > kw["n"]
    before = pair_rect.rect_pair.launches
    out = pair_rect.rect_pair(*args, **kw)
    assert pair_rect.rect_pair.launches == before + 1
    evals = int(pair_rect.rect_pair.evaluations.sum())
    model = pair_rect.culled_evaluations(
        pair_rect.rect_layout(args[0], args[7], kw["n"]), args[7],
        kw["r_cutoff"])
    assert abs(evals - model) <= 0.01 * model
    assert evals < args[0].shape[0] ** 2
    ref = pair_rect.rect_pair_reference(*args, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out[:, :3].cpu().numpy(),
                               ref[:, :3].cpu().numpy(), rtol=1e-3, atol=5e-2)
    for c in (3, 4, 5):
        np.testing.assert_allclose(float(out[:, c].double().sum()),
                                   float(ref[:, c].double().sum()),
                                   rtol=2e-5, atol=0.05, err_msg=f"col {c}")
    assert not out[kw["n"]:].any() and not out[:, 6:].any()
    # the source documents B3 as bitwise deterministic run to run
    for _ in range(2):
        assert torch.equal(pair_rect.rect_pair(*args, **kw), out)


def test_rect_kernel_rejects_bad_input(cuda):
    args, kw = _rect_setup(cuda, 128, False)
    for k, bad in ((0, args[0].double()), (1, args[1].cpu()),
                   (3, args[3][:-1])):
        wrong = list(args)
        wrong[k] = bad
        with pytest.raises(ValueError):
            pair_rect.rect_pair(*wrong, **kw)
    with pytest.raises(ValueError, match="real atoms"):
        pair_rect.rect_pair(*args, **dict(kw, n=args[0].shape[0] + 1))


# ---------------------------------------------------------- kernels B6-B8
@pytest.mark.parametrize("variant,plain,library", [
    ("variant_sublane", gtool.gather_rows_reference,
     lambda blk, idx: torch.index_select(blk, 0, idx[:, 0])),
    ("variant_lane", gtool.gather_lanes_reference,
     lambda blk, idx: torch.index_select(blk, 1, idx[0])),
    ("variant_lane_tiled", gtool.gather_lanes_tiled_reference,
     lambda blk, idx: torch.index_select(blk, 1, idx[0] % 128))])
def test_gather_kernels_match_plain(cuda, variant, plain, library):
    fn, (blk, idx) = getattr(gtool, variant)(device=cuda)
    before = fn.launches
    out = fn(blk, idx)
    assert fn.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, plain(blk, idx))
    assert torch.equal(out, library(blk, idx))
    assert torch.equal(fn(blk, idx), out)


@pytest.mark.parametrize("m", [131072, 1001, 6])
def test_lane_gathers_edges(cuda, m):
    """B7 with indices out of range (zeros, where the plain version raises)
    and m % 4 != 0, also on an index view one int past a 16-byte boundary;
    B8 bitwise equal to its plain version on the
    same in-range shapes."""
    rng = np.random.default_rng(m)
    blk = torch.as_tensor(rng.standard_normal((8, gtool.BLK), np.float32),
                          device=cuda)
    raw = rng.integers(-50, gtool.BLK + 50, (1, m + 1)).astype(np.int32)
    view = torch.as_tensor(raw, device=cuda)[:, 1:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    for idx in (torch.as_tensor(raw[:, :m], device=cuda), view):
        out = gtool.gather_lanes(blk, idx)
        ok = (idx[0] >= 0) & (idx[0] < gtool.BLK)
        ref = torch.where(ok[None, :], blk[:, torch.clamp(
            idx[0], 0, gtool.BLK - 1).long()], torch.zeros((), device=cuda))
        assert torch.equal(out, ref)
        inr = torch.clamp(idx, 0, gtool.BLK - 1)
        assert torch.equal(gtool.gather_lanes(blk, inr),
                           gtool.gather_lanes_reference(blk, inr))
        assert torch.equal(gtool.gather_lanes_tiled(blk, idx),
                           gtool.gather_lanes_tiled_reference(blk, idx))


def test_gather_kernels_reject_bad_input(cuda):
    fn, (blk, idx) = gtool.variant_sublane(device=cuda)
    with pytest.raises(ValueError, match="idx"):
        gtool.gather_rows(blk, idx.long())
    with pytest.raises(ValueError, match="blk"):
        gtool.gather_rows(blk.t(), idx)
    fn, (blk, idx) = gtool.variant_lane(device=cuda)
    with pytest.raises(ValueError, match="idx"):
        gtool.gather_lanes(blk, idx[:, :-1].t())
    with pytest.raises(RuntimeError, match="launch failed"):
        gtool.gather_lanes_tiled(blk[:, :64].contiguous(), idx)


# ------------------------------------------- the constraint-cluster kernels
# case -> (molecules of each kind, share of them on a box face, the
# buckets' (K, A))
CLUSTER_CASES = {
    "swm4_waters": ({"swm4": chip_smoke.CC_WATERS}, 0.3, [(3, 3)]),
    "ch3_stars": ({"ch3": 400}, 0.3, [(3, 4)]),
    "k1_pairs": ({"k1": 400}, 0.3, [(1, 2)]),
    "k2_waters": ({"k2": 400}, 0.3, [(2, 3)]),
    "ch4_stars": ({"ch4": 400}, 0.3, [(4, 5)]),
    "five_buckets": ({"swm4": 300, "ch3": 100, "k1": 60, "k2": 60,
                      "ch4": 60}, 0.3,
                     [(1, 2), (2, 3), (3, 3), (3, 4), (4, 5)]),
    "straddling": ({"swm4": 200, "ch3": 100, "ch4": 100}, 1.0,
                   [(3, 3), (3, 4), (4, 5)]),
}


def _cluster_setup(dev, case):
    counts, edge_share, keys = CLUSTER_CASES[case]
    pairs, dists, inv_m, pos, new, vel, box = chip_smoke.cluster_system(
        sorted(CLUSTER_CASES).index(case), counts, edge_share=edge_share)
    cons = constraints.build_constraint_data(pairs, dists, inv_m,
                                             device=dev)
    assert sorted((bk["K"], bk["A"]) for bk in cons.buckets) == keys
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return cons, pairs, dists, inv_m, t(pos), t(new), t(vel), t(box)


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
@pytest.mark.parametrize("velocities", [False, True])
def test_constraint_kernels_match_plain(cuda, case, velocities):
    cons, pairs, dists, _, pos, new, vel, box = _cluster_setup(cuda, case)
    if case == "straddling":
        # the minimum image joins the atoms of some clusters
        raw = (pos[pairs[:, 0]] - pos[pairs[:, 1]]).abs().max()
        assert float(raw) > 0.5 * float(box.min())
    ok, num = chip_smoke.constraint_agreement(
        cons, pos, vel if velocities else new, box, pairs, dists, velocities)
    assert ok, num


def test_constraint_entry_points_launch_once_a_bucket(cuda):
    """The entry points that Context calls take the kernel on CUDA tensors:
    one launch a bucket a call, the rows those of constraint_clusters."""
    cons, _, _, inv_m, pos, new, vel, box = _cluster_setup(cuda,
                                                           "five_buckets")
    inv_m = torch.as_tensor(inv_m, device=cuda)
    cc = constraints.constraint_clusters

    def counts():
        return cc.launches, cc.shake_launches, cc.rattle_launches

    total, shake, rattle = counts()
    p = constraints.apply_position_constraints(pos, new, box, cons, inv_m)
    assert counts() == (total + 5, shake + 5, rattle)
    v = constraints.apply_velocity_constraints(pos, vel, box, cons, inv_m)
    assert counts() == (total + 10, shake + 5, rattle + 5)
    assert torch.equal(p, cc(pos, new, box, cons, velocities=False))
    assert torch.equal(v, cc(pos, vel, box, cons, velocities=True))
    assert counts() == (total + 20, shake + 10, rattle + 10)


def test_constraint_kernels_reject_bad_input(cuda):
    """Bad tensors raise before any launch; so do rows fewer than the atoms
    the constraint data was built for (the kernels index rows by ``gid``
    unchecked) and constraint data built on another device."""
    cons, pairs, dists, inv_m, pos, new, vel, box = _cluster_setup(
        cuda, "five_buckets")
    cpu_cons = constraints.build_constraint_data(pairs, dists, inv_m,
                                                 device="cpu")
    cc = constraints.constraint_clusters
    before = (cc.launches, cc.shake_launches, cc.rattle_launches)
    for ref, target, b, data, name in (
            (pos, new.double(), box, cons, "target"),
            (pos.double(), new, box, cons, "ref"),
            (pos, new.t().contiguous().t(), box, cons, "target"),
            (pos[:-1], new, box, cons, "ref"),
            (pos, new, box.cpu(), cons, "box"),
            (pos, new, box.double(), cons, "box"),
            (pos[:-1], new[:-1], box, cons, "built for"),
            (pos, new, box, cpu_cons, "built for")):
        for velocities in (False, True):
            with pytest.raises(ValueError, match=name):
                cc(ref, target, b, data, velocities=velocities)
    assert (cc.launches, cc.shake_launches, cc.rattle_launches) == before
