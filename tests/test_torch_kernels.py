"""Kernel B1 (csrc/plist_pair.cu) against its plain torch version on the
card, for every tile size the ForceEvaluator can choose and both
specializations.  A CUDA kernel has no CPU mode, so these tests skip on a
machine without a card; chip_smoke.py runs the same comparison at the main
path's shapes.

Tolerance: rsqrtf is ~2 ulp from torch.rsqrt and nvcc contracts
multiply-adds, so kernel and plain version agree to float32 rounding;
the bounds are the JAX package's pair-sweep tolerances
(tests/test_pallas.py:179-182)."""
import numpy as np
import pytest
import torch

from openmm_velocityverlet_tpu_torch.ops import allpairs, pair_plist

pytestmark = pytest.mark.cuda

BETA, RC = 2.2, 1.2


def _grid_mol_system(rng, nx=4, ny=4, nz=24, lz=12.0, apm=4):
    """Molecules of ``apm`` mutually excluded atoms on a jittered grid in a
    tall box (the layout of tests/test_pallas.py:_grid_mol_system, built
    here without jax: the card's machine has none)."""
    n = nx * ny * nz * apm
    lj_type = rng.integers(0, 3, n)
    sig = rng.uniform(0.25, 0.4, 3)
    eps = rng.uniform(0.1, 1.0, 3)
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
        pytest.skip("needs a CUDA card: kernel B1 has no CPU mode")
    return torch.device("cuda")


def _setup(dev, ts, groups, nowrap):
    rng = np.random.default_rng(11)
    lj_type, a, b, excl, pos, box, q = _grid_mol_system(rng)
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
    return args, kw


@pytest.mark.parametrize("ts", [128, 256, 384])
@pytest.mark.parametrize("want_energy", [False, True])
@pytest.mark.parametrize("groups,nowrap,r_switch", [
    (False, True, 0.0), (True, False, 0.0), (False, False, 0.9)])
def test_plist_kernel_matches_plain(cuda, ts, want_energy, groups, nowrap,
                                    r_switch):
    args, kw = _setup(cuda, ts, groups, nowrap)
    kw["r_switch"] = r_switch
    before = pair_plist.plist_pair.launches
    rows, colacc = pair_plist.plist_pair(*args, want_energy=want_energy,
                                         **kw)
    assert pair_plist.plist_pair.launches == before + 1
    rows_p, col_p = pair_plist.plist_pair_reference(
        *args, want_energy=want_energy, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(rows[:, :3].cpu().numpy(),
                               rows_p[:, :3].cpu().numpy(),
                               rtol=1e-3, atol=5e-2)
    np.testing.assert_allclose(colacc.cpu().numpy(), col_p.cpu().numpy(),
                               rtol=1e-3, atol=5e-2)
    for c in (3, 4, 5):
        np.testing.assert_allclose(float(rows[:, c].double().sum()),
                                   float(rows_p[:, c].double().sum()),
                                   rtol=5e-5, atol=0.05)
    # the source documents B1 as bitwise deterministic run to run
    rows2, col2 = pair_plist.plist_pair(*args, want_energy=want_energy, **kw)
    assert torch.equal(rows, rows2) and torch.equal(colacc, col2)


def test_plist_kernel_rejects_bad_input(cuda):
    args, kw = _setup(cuda, 128, False, False)
    bad = list(args)
    bad[4] = args[4].double()
    with pytest.raises(ValueError, match="pos"):
        pair_plist.plist_pair(*bad, **kw)
