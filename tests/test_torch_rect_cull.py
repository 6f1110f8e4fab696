"""Kernel B3's enumeration on the CPU (``ops/pair_rect.py``): the Morton
layout, the chunk-pair skip and the column vote keep every pair within the
cutoff, and the culled sweep with its band pass of excluded pairs
(``rect_pair_culled``, the kernel's enumeration in plain torch) equals the
plain version ``rect_pair_reference``, which tests/test_torch_rect.py holds
against the JAX ``_run``.

The systems are four-atom molecules, mutually excluded, on a jittered
lattice: a cube with atoms across its faces, a tall box, positions moved by
whole box lengths, an atom count that is not a multiple of 32, interaction
groups with an LJ switch, and molecules whose members sit on random sites,
so that most excluded pairs lie beyond the cutoff.

Tolerances: the B3 kernel's against its plain version
(tests/test_torch_kernels.py, from the JAX package's tests/test_pallas.py:
105-107, 127-131, 179-182): forces rtol 1e-3 / atol 5e-2, energy sums rtol
2e-5 / atol 0.05.  The sweep adds each row's pairs in another order, so the
two agree to float32 rounding."""
import numpy as np
import pytest
import torch

from openmm_velocityverlet_tpu_torch.ops import allpairs, pair_rect, pair_tri

BETA, RC = 2.2, 1.2
F_RTOL, F_ATOL = 1e-3, 5e-2
E_RTOL, E_ATOL = 2e-5, 0.05

CASES = {
    # name: (lattice sites a side, spacing nm, drop atoms, options)
    "cube_across_faces": ((12, 12, 12), 0.3, 0, {}),
    "tall_box": ((8, 8, 31), 0.3, 0, {}),
    "unwrapped": ((12, 12, 12), 0.3, 0, dict(unwrap=True)),
    "n_not_multiple_of_32": ((12, 12, 12), 0.3, 13, {}),
    "groups_switch": ((12, 12, 12), 0.3, 0, dict(groups=True)),
    "stretched_exclusions": ((12, 12, 12), 0.3, 0, dict(stretch=True)),
}


def rect_system(dims, spacing, drop=0, *, unwrap=False, groups=False,
                stretch=False, seed=5, blk=128, device="cpu"):
    """Four-atom molecules (each atom excluded with the other three) on a
    jittered lattice of ``dims`` sites ``spacing`` apart, shifted by a
    third of a spacing so that atoms sit across the box faces, less the
    last ``drop`` atoms; ``unwrap`` moves each atom by a random whole
    number of box lengths (-2..2 an axis), ``stretch`` puts each atom on a
    random site; ``groups`` adds two interaction groups and the LJ switch
    at 0.9 nm.  Returns (args, kw) for ``rect_pair_reference`` on the
    unsorted layout padded to ``blk`` with pads at 1e6."""
    rng = np.random.default_rng(seed)
    dims = np.asarray(dims)
    box = (dims * spacing).astype(np.float32)
    grid = np.stack(np.meshgrid(*(np.arange(d) for d in dims),
                                indexing="ij"), -1).reshape(-1, 3)
    if stretch:
        grid = grid[rng.permutation(grid.shape[0])]
    n = grid.shape[0] - drop
    pos = (grid[:n] + 0.5) * spacing - spacing / 3.0 \
        + rng.uniform(-0.04, 0.04, (n, 3))
    if unwrap:
        pos = pos + rng.integers(-2, 3, (n, 3)) * box
    pos = pos.astype(np.float32)
    n_types = 3
    lj_type = rng.integers(0, n_types, n)
    sig = rng.uniform(0.2, 0.28, n_types)
    eps = rng.uniform(0.1, 1.0, n_types)
    a = np.sqrt(np.outer(eps, eps)) ** 0.5 * np.outer(sig, sig) ** 3 * 2.0
    b = 2.0 * np.sqrt(np.outer(eps, eps)) * np.outer(sig, sig) ** 3 * 2.0
    excl = np.full((n, 3), -1, np.int64)
    for i in range(n):
        for k, j in enumerate(range(i + 1, min(i - i % 4 + 4, n))):
            excl[i, k] = j
    lj_group = rng.integers(0, 2, n) if groups else None
    allowed = np.array([[True, True], [True, False]]) if groups else None
    tables = allpairs.build_pair_tables(n, lj_type, a, b, excl, lj_group,
                                        allowed, fold_exc14=False)
    q = rng.normal(0, 0.5, n).astype(np.float32)
    n_pad = pair_tri.padded_size(n, blk)
    st = pair_tri.band_statics(q, tables, n_pad, device)
    pos2d = torch.cat([torch.as_tensor(pos, device=device),
                       torch.full((n_pad - n, 3), 1e6, device=device)])
    args = (pos2d.contiguous(), st["q"], st["ab"], st["bits"], st["ljt"],
            st["grp"], st["grows"],
            torch.as_tensor(box, dtype=torch.float32, device=device))
    kw = dict(n=n, t_dim=n_types, beta=BETA, r_cutoff=RC,
              r_switch=0.9 if groups else 0.0)
    return args, kw


def _build(name):
    dims, spacing, drop, opts = CASES[name]
    return rect_system(dims, spacing, drop, **opts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cull_keeps_every_pair_within_the_cutoff(name):
    """Every pair within the cutoff (float64 minimum image) lies in a chunk
    pair that ``chunk_reach`` keeps, from both sides, and in a column that
    ``column_reach`` keeps; the layout holds each real atom once and no
    pad."""
    args, kw = _build(name)
    pos, box, n = args[0], args[7], kw["n"]
    lay = pair_rect.rect_layout(pos, box, n)
    oid = lay["oid"].numpy()
    assert sorted(oid[oid >= 0].tolist()) == list(range(n))
    assert (oid[n:] == -1).all() and len(oid) == -(-n // 32) * 32
    slot = np.empty(n, np.int64)
    slot[oid[oid >= 0]] = np.nonzero(oid >= 0)[0]
    reach = pair_rect.chunk_reach(lay, box, RC).numpy()
    colk = pair_rect.column_reach(lay, box, RC).numpy()
    p = pos[:n].double().numpy()
    L = box.double().numpy()
    total = 0
    for s in range(0, n, 512):
        d = p[s:s + 512, None, :] - p[None, :, :]
        d -= L * np.round(d / L)
        i, j = np.nonzero(((d * d).sum(-1) < RC * RC)
                          & (np.arange(n)[None, :] != np.arange(
                              s, min(s + 512, n))[:, None]))
        i = i + s
        si, sj = slot[i], slot[j]
        assert reach[si // 32, sj // 32].all()
        assert colk[si // 32, sj].all()
        total += len(i)
    assert total > 0
    if L.max() > 4 * RC:
        # the skip culls along an axis several cutoffs long
        assert reach.mean() < 0.8


@pytest.mark.parametrize("name", sorted(CASES))
def test_culled_sweep_matches_reference(name):
    """The culled sweep plus the band pass against the plain version: every
    row's force, each energy column's sum, zero pad rows and columns 6-7,
    and fewer evaluations than the full sweep's n_pad^2."""
    args, kw = _build(name)
    ref = pair_rect.rect_pair_reference(*args, **kw)
    got, evaluations = pair_rect.rect_pair_culled(*args, **kw)
    n, n_pad = kw["n"], args[0].shape[0]
    np.testing.assert_allclose(got[:, :3].numpy(), ref[:, :3].numpy(),
                               rtol=F_RTOL, atol=F_ATOL)
    for c in (3, 4, 5):
        np.testing.assert_allclose(float(got[:, c].double().sum()),
                                   float(ref[:, c].double().sum()),
                                   rtol=E_RTOL, atol=E_ATOL,
                                   err_msg=f"column {c}")
    assert not got[n:].any() and not got[:, 6:].any()
    assert 0 < evaluations < n_pad * n_pad
    if name == "stretched_exclusions":
        # the correction is there, and comes from pairs beyond the cutoff
        d = args[0][:n, None, :] - args[0][None, :n, :]
        d = d - args[7] * torch.round(d / args[7])
        r2 = (d * d).sum(-1)
        i = torch.arange(n)
        same = (i[:, None] // 4 == i[None, :] // 4) & (i[:, None] != i)
        assert bool((r2[same] > RC * RC).float().mean() > 0.5)
        assert abs(float(ref[:, 5].double().sum())) > 1.0


def test_morton_key_interleaves_the_cell_bits():
    """``pair_plist._morton_key``, the sort key of B1's cache and of B3's
    layout: bit b of the x, y, z cells (64 a side, of the wrapped
    positions) at bits 3b, 3b + 1, 3b + 2; pads at 1 << 20."""
    from openmm_velocityverlet_tpu_torch.ops.pair_plist import _morton_key
    rng = np.random.default_rng(9)
    box = torch.tensor([5.44, 8.84, 40.8])
    pos = torch.as_tensor(rng.uniform(-2.0, 3.0, (4096, 3)),
                          dtype=torch.float32) * box
    key = _morton_key(pos, box, 4100)
    w = pos - box * torch.floor(pos / box)
    cell = torch.clamp((w / box * 64.0).to(torch.int32), 0, 63).numpy()
    want = np.zeros(4096, np.int64)
    for b in range(6):
        for ax in range(3):
            want |= ((cell[:, ax] >> b) & 1).astype(np.int64) << (3 * b + ax)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key[:4096].numpy(), want)
    assert (key[4096:] == 1 << 20).all()
