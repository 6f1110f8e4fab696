"""Parity of the port's band half of the pair machinery with the JAX
package: the kernel-folded 1-4 tables and the dense sweep that uses them,
the z-sort cache and its coverage check, the plain version of kernel B2
against the Pallas ``_run_tri`` in interpret mode in every enumeration, the
band branch of ``direct_space_pallas``, and the strict (exact fallback)
mode of the band and plist sweeps.

Tolerances are the JAX package's own (tests/test_pallas.py): forces rtol
1e-3 / atol 5e-2; energies rtol 2e-5 (:105-107), with folded 1-4
exceptions rtol 5e-5 / atol 1e-3 (:397-400), and rtol 5e-5 / atol 0.05 where
a stale sort changes the float32 summation order (:127-131)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu.forces import ForceEvaluator as JFE
from openmm_velocityverlet_tpu.ops import allpairs as jap
from openmm_velocityverlet_tpu.ops import pallas_pair as jpp
from openmm_velocityverlet_tpu.units import ONE_4PI_EPS0
from openmm_velocityverlet_tpu_torch.forces import ForceEvaluator as TFE
from openmm_velocityverlet_tpu_torch.ops import allpairs as tap
from openmm_velocityverlet_tpu_torch.ops import pair_plist as tpp
from openmm_velocityverlet_tpu_torch.ops import pair_tri as tpt
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from tests.test_pallas import _mol_system
from tests.test_torch_pair import assert_forces_close

BETA, RC = 2.2, 1.2
F_RTOL, F_ATOL = 1e-3, 5e-2


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _exceptions(n, lj_type, a, b, q, extra=False):
    """Regular 1-4 exceptions on (4m, 4m+3), as tests/test_pallas.py:362.
    ``extra`` adds what must stay in the sparse term pass or be dropped: an
    irregular Coulomb scale, a pure exclusion, an LJ pair inconsistent with
    its type pair's first (a14, b14), and a partner beyond the 31-offset
    window."""
    xa = 3 if extra else 1
    idx = np.full((n, xa), -1, np.int32)
    qq = np.zeros((n, xa), np.float32)
    c6 = np.zeros((n, xa), np.float32)
    c12 = np.zeros((n, xa), np.float32)
    fill = np.zeros(n, int)

    def add(i, j, qq_ij, c6_ij, c12_ij):
        for u, v in ((i, j), (j, i)):
            k = fill[u]
            idx[u, k], qq[u, k], c6[u, k], c12[u, k] = v, qq_ij, c6_ij, c12_ij
            fill[u] += 1

    for m in range(n // 4):
        i, j = 4 * m, 4 * m + 3
        ti, tj = lj_type[i], lj_type[j]
        add(i, j, ONE_4PI_EPS0 * 0.5 * q[i] * q[j], 0.6 * b[ti, tj],
            (0.5 * a[ti, tj]) ** 2)
    if extra:
        add(1, 2, ONE_4PI_EPS0 * 0.3 * q[1] * q[2], 0.0, 0.0)   # irregular
        add(5, 6, 0.0, 0.0, 0.0)                                # pure excl.
        # a later pair of the type pair of (0, 3) with other LJ numbers
        k = next(i for i in range(9, n - 1, 4)
                 if (lj_type[i], lj_type[i + 1]) == (lj_type[0], lj_type[3]))
        add(k, k + 1, ONE_4PI_EPS0 * 0.5 * q[k] * q[k + 1],
            0.9 * b[lj_type[0], lj_type[3]], 1e-9)
        add(13, 60, ONE_4PI_EPS0 * 0.5 * q[13] * q[60], 0.0, 0.0)  # far
    return dict(exc_idx=idx, exc_qq=qq, exc_c6=c6, exc_c12=c12, charges=q)


def _system(n_mol, seed=3, has14=False, groups=False, extra=False):
    rng = np.random.default_rng(seed)
    lj_type, a, b, excl, pos, box, q = _mol_system(n_mol, rng)
    n = len(lj_type)
    q = q.astype(np.float32)
    kw = dict(fold_exc14=has14)
    if has14:
        kw.update(_exceptions(n, lj_type, a, b, q, extra))
    if groups:
        kw.update(lj_group=rng.integers(0, 2, n),
                  lj_group_allowed=np.array([[True, True], [True, False]]))
    tables = jap.build_pair_tables(n, lj_type, a, b, excl, **kw)
    assert bool(tables["has_exc14"]) == has14
    return tables, pos.astype(np.float32), box, q


def test_fold_exc14_tables_match_jax():
    """build_pair_tables(fold_exc14=True) key by key: the folded bits, the
    1-4 LJ rows and the term mask that drops folded and pure-exclusion
    entries but keeps the irregular, inconsistent and distant ones."""
    rng = np.random.default_rng(3)
    lj_type, a, b, excl, pos, box, q = _mol_system(64, rng)
    n = len(lj_type)
    exc = _exceptions(n, lj_type, a, b, q.astype(np.float32), extra=True)
    for fold in (True, False):
        ref = jap.build_pair_tables(n, lj_type, a, b, excl, fold_exc14=fold,
                                    **exc)
        mine = tap.build_pair_tables(n, lj_type, a, b, excl,
                                     fold_exc14=fold, **exc)
        assert set(mine) == set(ref)
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(mine[k], v, err_msg=k)
            else:
                assert mine[k] == v, k
        mask = ref["exc_term_mask"]
        assert ref["has_exc14"] == fold
        # the pure exclusion is always dropped; the others stay
        assert not mask[5].any() and mask[1].any() and mask[13].any()
        if fold:
            k = np.nonzero(exc["exc_c12"][:, 0] == np.float32(1e-9))[0][0]
            assert not mask[0].any() and mask[k].any()


def test_dense_exc14_matches_jax():
    tables, pos, box, q = _system(96, seed=7, has14=True, groups=True)
    ref = jap.direct_space_dense(jnp.asarray(pos), box, jnp.asarray(q),
                                 tables, BETA, RC, 256)
    got = tap.direct_space_dense(_t(pos), _t(box), _t(q), tables, BETA, RC,
                                 256)
    assert abs(float(ref[3])) > 1.0 and abs(float(ref[4])) > 1e-3
    for x, y in zip(ref[:5], got[:5]):
        np.testing.assert_allclose(float(y), float(x), rtol=5e-5, atol=1e-3)
    assert_forces_close(got[5].numpy(), np.asarray(ref[5]))


def _layouts(tables, pos, box, q, ts, z_sorted):
    """The same layout for both packages: the JAX ``_run_tri`` operands
    (z-sorted from the JAX cache, or unsorted from ``_padded_statics``) and
    the port's ``run_tri`` operands."""
    n = pos.shape[0]
    n_pad = tpt.padded_size(n, ts)
    pad = n_pad - n
    pos2d = jnp.concatenate([jnp.asarray(pos),
                             jnp.full((pad, 3), 1e6, jnp.float32)])
    if z_sorted:
        jc = jax.jit(lambda p, qq: jpp.make_pair_cache(
            p, box, qq, tables, ts))(jnp.asarray(pos), jnp.asarray(q))
        pos2d = pos2d[jc.perm]
        jargs = (pos2d, jc.q2d, jc.ab, jc.bits2d, jc.bits14_2d,
                 jc.perm.reshape(-1, 1), jc.grows, pos2d.T, jc.qT,
                 jc.onehotT, jc.bitsT, jc.bits14T, jc.oidT, jc.gonehotT)
        tc = tpt.make_pair_cache(_t(pos), _t(box), q, tables, ts)
        np.testing.assert_array_equal(tc.perm.numpy(), np.asarray(jc.perm))
        oid = tc.oid
    else:
        q2d, ab, bits2d, b14, oh, grows, goh = jpp._padded_statics(
            n, pad, jnp.asarray(q), tables)
        oid2d = jnp.arange(n_pad, dtype=jnp.int32).reshape(-1, 1)
        jargs = (pos2d, q2d, ab, bits2d, b14, oid2d, grows, pos2d.T, q2d.T,
                 oh.T, bits2d.T, b14.T, oid2d.T, goh.T)
        st = tpt.band_statics(q, tables, n_pad, "cpu")
        tc = tpt.BandCache(perm=torch.arange(n_pad), invperm=None, oid=None,
                           **st)
        oid = torch.arange(n_pad, dtype=torch.int32)
    targs = (_t(np.asarray(pos2d)), tc.q, tc.ab, tc.bits, tc.bits14, oid,
             tc.ljt, tc.grp, tc.grows, _t(box))
    return jargs + (jnp.asarray(box),), targs


# (n_mol, band_w, full_sweep, z_sorted): bandall at W = 3 on 12 tiles of
# 128; band + far (band_w = 0) on the unsorted layout; the full sweep on 11
# (odd) and 12 (even) tiles, the latter through the dedup guard.  On the
# z-sorted layout the tile pairs at offset n_tiles / 2 lie half a box apart
# and never interact, so the guard shows only on the unsorted layout, where
# every tile spans the box
TRI = {"bandall": (384, 3, False, True), "band+far": (384, 0, False, False),
       "full_odd": (352, 0, True, True), "full_even": (384, 0, True, True),
       "full_even_unsorted": (384, 0, True, False)}


@pytest.mark.parametrize("case,has14,want_energy,groups", [
    ("bandall", False, True, False), ("bandall", False, False, True),
    ("bandall", True, True, False), ("bandall", True, False, True),
    ("band+far", False, True, False), ("band+far", True, False, True),
    ("full_odd", False, True, True), ("full_odd", True, False, False),
    ("full_even", False, False, False), ("full_even", True, True, True),
    ("full_even_unsorted", True, True, True)])
def test_run_tri_matches_jax(case, has14, want_energy, groups):
    """rows and colacc of the port's run_tri (kernel B2's plain version on
    the CPU) against the JAX _run_tri in interpret mode on one layout."""
    n_mol, band_w, full, z_sorted = TRI[case]
    tables, pos, box, q = _system(n_mol, has14=has14, groups=groups)
    jargs, targs = _layouts(tables, pos, box, q, 128, z_sorted)
    kw = dict(beta=BETA, r_cutoff=RC, ts=128, t_dim=tables["arows"].shape[1],
              has14=has14, band_w=band_w, want_energy=want_energy,
              full_sweep=full)
    rows_j, col_j = jpp._run_tri(*jargs, n_real=pos.shape[0],
                                 interpret=True, **kw)
    rows_t, col_t = tpt.run_tri(*targs, **kw)
    rows_j, col_j = np.asarray(rows_j), np.asarray(col_j)
    assert_forces_close(rows_t[:, :3].numpy(), rows_j[:, :3])
    np.testing.assert_allclose(col_t[3:].numpy(), col_j[3:], rtol=F_RTOL,
                               atol=F_ATOL)
    assert_forces_close(col_t[:3].numpy().T, col_j[:3].T)
    e_rtol, e_atol = (5e-5, 1e-3) if has14 else (2e-5, 1e-6)
    for c in range(3, 8):
        np.testing.assert_allclose(float(rows_t[:, c].double().sum()),
                                   float(rows_j[:, c].astype(float).sum()),
                                   rtol=e_rtol, atol=e_atol, err_msg=str(c))
    if has14 and want_energy:
        assert abs(float(rows_j[:, 6].sum())) > 1.0


@pytest.mark.parametrize("has14", [False, True])
def test_direct_space_band_matches_jax(has14):
    """The band branch of direct_space_pallas (band_w = 3, relaxed):
    energies with the folded 1-4 terms, forces and the coverage flag; and
    both against the dense sweep."""
    tables, pos, box, q = _system(384, seed=5, has14=has14)
    ref = jpp.direct_space_pallas(
        jnp.asarray(pos), box, jnp.asarray(q), tables, BETA, RC, ts=128,
        interpret=True, band_w=3, with_flag=True, strict=False)
    got = tpt.direct_space_band(_t(pos), _t(box), _t(q), tables, BETA, RC,
                                128, 3)
    dense = tap.direct_space_dense(_t(pos), _t(box), _t(q), tables, BETA,
                                   RC, 256)
    assert bool(got[6]) == bool(ref[6]) is False
    for x, y, z in zip(ref[:5], got[:5], dense[:5]):
        np.testing.assert_allclose(float(y), float(x), rtol=5e-5, atol=1e-3)
        np.testing.assert_allclose(float(z), float(x), rtol=5e-5, atol=1e-3)
    assert_forces_close(got[5].numpy(), np.asarray(ref[5]))
    assert_forces_close(got[5].numpy(), dense[5].numpy())


def test_band_cache_and_coverage_match_jax():
    """perm and band_coverage_bad equal to the JAX package's on a fresh
    cache (covered), a stale cache (a slab of molecules moved 4 nm in z
    since the sort) and an undersized band (tests/test_pallas.py:110-154);
    and the tile_multiple layout."""
    tables, pos, box, q = _system(384, seed=4)
    jq = jnp.asarray(q)

    def both(cache_pos, cur_pos, band_w, tile_multiple=1):
        jc = jax.jit(lambda p: jpp.make_pair_cache(
            p, box, jq, tables, 128, tile_multiple=tile_multiple))(
            jnp.asarray(cache_pos))
        tc = tpt.make_pair_cache(_t(cache_pos), _t(box), q, tables, 128,
                                 tile_multiple=tile_multiple)
        np.testing.assert_array_equal(tc.perm.numpy(), np.asarray(jc.perm))
        np.testing.assert_array_equal(tc.invperm.numpy(),
                                      np.asarray(jc.invperm))
        np.testing.assert_array_equal(tc.ab.numpy(), np.asarray(jc.ab))
        np.testing.assert_array_equal(tc.bits.numpy(),
                                      np.asarray(jc.bits2d)[:, 0])
        flag_j = bool(jpp.band_coverage_bad(jnp.asarray(cur_pos), box, jc,
                                            128, band_w, RC))
        flag_t = bool(tpt.band_coverage_bad(_t(cur_pos), _t(box), tc, 128,
                                            band_w, RC))
        assert flag_t == flag_j
        return flag_t

    assert both(pos, pos, 3) is False
    stale = pos.copy()
    stale[:400, 2] += 4.0
    assert both(stale, pos, 3) is True
    assert both(pos, pos, 1) is True
    assert both(pos, pos, 3, tile_multiple=5) is False


def test_strict_band_takes_full_sweep():
    """strict=True with an undersized band: the flag is read on the host,
    the full sweep runs, and the result equals JAX's strict band branch and
    the dense sweep."""
    tables, pos, box, q = _system(384, seed=4, has14=True)
    ref = jpp.direct_space_pallas(
        jnp.asarray(pos), box, jnp.asarray(q), tables, BETA, RC, ts=128,
        interpret=True, band_w=1, with_flag=True, strict=True)
    got = tpt.direct_space_band(_t(pos), _t(box), _t(q), tables, BETA, RC,
                                128, 1, strict=True)
    dense = tap.direct_space_dense(_t(pos), _t(box), _t(q), tables, BETA,
                                   RC, 256)
    assert got[6] is True and bool(ref[6])
    for x, y, z in zip(ref[:5], got[:5], dense[:5]):
        np.testing.assert_allclose(float(y), float(x), rtol=5e-5, atol=1e-3)
        np.testing.assert_allclose(float(z), float(x), rtol=5e-5, atol=1e-3)
    assert_forces_close(got[5].numpy(), np.asarray(ref[5]))
    assert_forces_close(got[5].numpy(), dense[5].numpy())


@pytest.mark.parametrize("sort,trip", [("z", "stale"),
                                       ("morton", "overflow")])
def test_strict_plist_stale_cache(sort, trip):
    """strict plist on a stale cache (built a third of the box away) or an
    overflowed list: the coverage flag trips on both sides, the exhaustive
    sorted-layout sweep runs, and the forces and energies equal JAX's
    strict=True and the dense sweep."""
    tables, pos, box, q = _system(384, seed=5)
    cache_pos = pos.copy()
    if trip == "stale":
        cache_pos[:1200, 2] += 4.0
    cnt = jpp.count_candidates_np(cache_pos, box, 128, RC + 0.1, mode=sort)
    cap = int(cnt * 1.6) + 16 if trip == "stale" else 3
    jc = jax.jit(lambda p, qq: jpp.make_pair_cache(
        p, box, qq, tables, 128, mode=sort, cap=cap, rc_cand=RC + 0.1))(
        jnp.asarray(cache_pos), jnp.asarray(q))
    tc = tpp.make_pair_cache(_t(cache_pos), _t(box), q, tables, 128,
                             mode=sort, cap=cap, rc_cand=RC + 0.1)
    ref = jpp.direct_space_pallas(
        jnp.asarray(pos), box, jnp.asarray(q), tables, BETA, RC, ts=128,
        interpret=True, mode="plist", plist_cap=cap, plist_sort=sort,
        cache=jc, with_flag=True, strict=True)
    got = tpp.direct_space_plist(_t(pos), _t(box), _t(q), tables, BETA, RC,
                                 128, cache=tc, plist_cap=cap,
                                 plist_sort=sort, strict=True)
    dense = tap.direct_space_dense(_t(pos), _t(box), _t(q), tables, BETA,
                                   RC, 256)
    assert got[6] is True and bool(ref[6])
    for x, y, z in zip(ref[:3], got[:3], dense[:3]):
        np.testing.assert_allclose(float(y), float(x), rtol=5e-5, atol=0.05)
        np.testing.assert_allclose(float(z), float(x), rtol=5e-5, atol=0.05)
    assert_forces_close(got[5].numpy(), np.asarray(ref[5]))
    assert_forces_close(got[5].numpy(), dense[5].numpy())


def _chain_system(builder_cls, n_mol=125, seed=3):
    """Four-atom chains of 0.12 nm bonds on a 0.55 nm lattice, full
    intramolecular exclusions and a regular 1-4 exception on each chain's
    ends, plus one irregular one (0.3 q q) that stays in the term pass.
    Built by either package's SystemBuilder from the same code."""
    rng = np.random.default_rng(seed)
    b = builder_cls()
    side = int(np.ceil(n_mol ** (1.0 / 3.0)))
    box = np.array([side * 0.55] * 3)
    sig, eps = [0.30, 0.25, 0.35], [0.5, 0.2, 0.8]
    pos = []
    for m in range(n_mol):
        c = (np.array([m % side, (m // side) % side, m // side ** 2])
             + 0.5) * 0.55
        types = rng.integers(0, 3, 4)
        qs = rng.normal(0, 0.4, 4)
        ids = [b.add_particle(12.0, charge=float(qs[k]),
                              lj_type=int(types[k])) for k in range(4)]
        u = rng.normal(size=3)
        pos += [c + (k - 1.5) * 0.12 * u / np.linalg.norm(u)
                for k in range(4)]
        for i in range(4):
            for j in range(i + 1, 4):
                b.add_exclusion(ids[i], ids[j])
        t0, t3 = sorted((int(types[0]), int(types[3])))
        scale = 0.3 if m == 7 else 0.5
        b.add_exception(ids[0], ids[3], scale * float(qs[0] * qs[3]),
                        0.5 * (sig[t0] + sig[t3]),
                        0.5 * np.sqrt(eps[t0] * eps[t3]))
    b.set_lj_from_type_params(sig, eps)
    system = b.finalize(box, r_cutoff=0.9, use_pme=True)
    return system, np.asarray(pos, np.float32), box


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX ForceEvaluator does not forward ``pallas_interpret`` to
    ``direct_space_pallas`` (ROADMAP C); run its Pallas kernels in
    interpret mode, as tests/test_torch_slice.py does."""
    monkeypatch.setattr(jpp, "direct_space_pallas", functools.partial(
        jpp.direct_space_pallas, interpret=True))


def test_force_evaluator_fold_exc14_matches_jax(jax_pallas_interpret):
    """ForceEvaluator(fold_exc14=True) on a system with 1-4 exceptions: the
    band sweep (16 tiles of 32, the band width sized from the start
    configuration) folds the regular ones and the term pass keeps only the
    irregular one (``exc_term_mask``), so no exception counts twice.  Terms
    and forces against the JAX evaluator with the same options, and the
    exception energies and forces against the port's unfolded evaluator."""
    js, pos, box = _chain_system(jpkg.SystemBuilder)
    ps, pos_p, _ = _chain_system(tpkg.SystemBuilder)
    np.testing.assert_array_equal(pos, pos_p)
    ps = system_from_numpy(js)
    jf = JFE(js, pair_kernel="pallas", pallas_interpret=True, box_hint=box,
             pos_hint=pos, recip="exact", fold_exc14=True, pair_ts=32)
    tf = TFE(ps, box_hint=box, pos_hint=pos, device="cpu", fold_exc14=True,
             pair_ts=32)
    assert (tf.pairs.mode, tf.pairs.ts, tf.pairs.band_w,
            tf.pairs.carries_cache) == (jf.pair_mode, jf.pair_ts, jf.band_w,
                                        True)
    assert tf.pair_tables["has_exc14"]
    assert int(tf.pair_tables["exc_term_mask"].sum()) == 2
    bt = torch.as_tensor(box, dtype=torch.float32)
    unfolded = TFE(ps, box_hint=box, pos_hint=pos, device="cpu")
    _, f_unf = unfolded.energy_forces(torch.as_tensor(pos), bt)
    t_unf, _ = unfolded.energy_forces(torch.as_tensor(pos), bt)
    for want_energy in (True, False):
        tj, fj = jax.jit(functools.partial(
            jf.energy_forces, want_energy=want_energy))(
            jnp.asarray(pos), jnp.asarray(box, jnp.float32))
        tt, ft = tf.energy_forces(torch.as_tensor(pos), bt,
                                  want_energy=want_energy)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=F_RTOL,
                                   atol=F_ATOL)
        np.testing.assert_allclose(ft.numpy(), f_unf.numpy(), rtol=F_RTOL,
                                   atol=F_ATOL)
        if want_energy:
            assert set(tt) == set(tj)
            for k in tj:
                np.testing.assert_allclose(float(tt[k]), float(tj[k]),
                                           rtol=5e-5, atol=0.05, err_msg=k)
            for k in ("exception_coul", "exception_lj"):
                assert abs(float(t_unf[k])) > 1.0
                np.testing.assert_allclose(float(tt[k]), float(t_unf[k]),
                                           rtol=5e-5, atol=0.05, err_msg=k)


# ---------------------------------------------- the row-sharded form of B2
@pytest.mark.parametrize("n_mol,full", [(384, False), (384, True),
                                        (352, False), (352, True)])
def test_row_sharded_halves_sum_to_unsharded(n_mol, full):
    """``row_off`` / ``n_row_tiles``: two calls over the two halves of the
    row tiles (12 tiles even, 11 odd; the band at W = 3 and the full sweep
    with its dedup guard on the global row tile) give the unsharded rows,
    and their column accumulators add up to the unsharded one."""
    tables, pos, box, q = _system(n_mol, has14=True)
    _, targs = _layouts(tables, pos, box, q, 128, True)
    n_tiles = targs[0].shape[0] // 128
    kw = dict(ts=128, t_dim=tables["arows"].shape[1], beta=BETA,
              r_cutoff=RC, has14=True, mode="bandall", full_sweep=full,
              band_w=n_tiles // 2 if full else 3)
    rows, col = tpt.tri_pair(*targs, **kw)
    h = n_tiles // 2
    r0, c0 = tpt.tri_pair(*targs, row_off=0, n_row_tiles=h,
                          n_tiles_g=n_tiles, **kw)
    r1, c1 = tpt.tri_pair(*targs, row_off=h, n_row_tiles=n_tiles - h,
                          n_tiles_g=n_tiles, **kw)
    assert r0.shape == (h * 128, 8) and c0.shape == col.shape
    np.testing.assert_array_equal(torch.cat([r0, r1]).numpy(), rows.numpy())
    assert_forces_close((c0 + c1)[:3].numpy().T, col[:3].numpy().T)
    assert float(col[:3].abs().max()) > 1.0
    with pytest.raises(ValueError, match="row"):
        tpt.tri_pair(*targs, row_off=h, n_row_tiles=n_tiles, **kw)
    with pytest.raises(ValueError, match="bandall"):
        tpt.tri_pair(*targs, **dict(kw, mode="far", row_off=1))


@pytest.mark.parametrize("full,row_off", [(False, 6), (True, 6), (False, 0)])
def test_row_sharded_half_matches_jax(full, row_off):
    """One half of the row tiles against the JAX ``_tri_call(row_off=,
    n_tiles_g=)`` in interpret mode: local row blocks, full-length column
    tables, at the tolerances of test_run_tri_matches_jax."""
    tables, pos, box, q = _system(384, has14=True)
    jargs, targs = _layouts(tables, pos, box, q, 128, True)
    n_tiles, half, ts = 12, 6, 128
    w = n_tiles // 2 if full else 3
    sl = slice(row_off * ts, (row_off + half) * ts)
    rows_args = tuple(a[sl] for a in jargs[:7])
    rows_j, col_j = jpp._tri_call(
        "bandall", (half, w + 1), *rows_args, *jargs[7:], BETA, RC, ts,
        pos.shape[0], tables["arows"].shape[1], True, True,
        want_energy=True, full_sweep=full,
        row_off=jnp.asarray([row_off], jnp.int32), n_tiles_g=n_tiles)
    rows_t, col_t = tpt.tri_pair(
        *targs, ts=ts, t_dim=tables["arows"].shape[1], beta=BETA,
        r_cutoff=RC, has14=True, mode="bandall", band_w=w, full_sweep=full,
        row_off=row_off, n_row_tiles=half, n_tiles_g=n_tiles)
    rows_j, col_j = np.asarray(rows_j), np.asarray(col_j)
    assert rows_t.shape == rows_j.shape
    assert_forces_close(rows_t[:, :3].numpy(), rows_j[:, :3])
    assert_forces_close(col_t[:3].numpy().T, col_j[:3].T)
    for c in range(3, 8):
        np.testing.assert_allclose(float(rows_t[:, c].double().sum()),
                                   float(rows_j[:, c].astype(float).sum()),
                                   rtol=5e-5, atol=1e-3, err_msg=str(c))


# ------------------------------------------------- a plain-cutoff system
def _lj_fluid(n_side=8, spacing=0.4, charge=0.0):
    """An argon-like fluid without Ewald (``use_pme=False``: ewald_beta 0),
    the layout of tests/test_smoke.make_lj_fluid, jittered off its
    lattice."""
    b = tpkg.SystemBuilder()
    for i in range(n_side ** 3):
        b.add_particle(39.948, charge=charge * (-1) ** i, lj_type=0)
    b.set_lj_from_type_params([0.34], [0.996])
    box = np.array([n_side * spacing] * 3)
    pos = np.stack(np.meshgrid(*[np.arange(n_side) * spacing + spacing / 2]
                               * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = pos + np.random.default_rng(2).normal(0, 0.02, pos.shape)
    system = b.finalize(box, r_cutoff=0.75, use_pme=False)
    return system, pos.astype(np.float32), box


@pytest.mark.parametrize("charge", [0.0, 0.3])
def test_no_ewald_fluid_builds_and_matches_dense(charge):
    """ewald_beta 0: the Chebyshev fit has nothing to fit and returns zero
    coefficients, so the plist sweep and the band sweep build and give the
    dense sweep's forces and energies."""
    system, pos, box = _lj_fluid(charge=charge)
    assert system.ewald_beta == 0
    assert tpp._pfit(0.0, 0.75) == (0.0,) * 11
    assert tpp._pfit_scaled(0.0, 0.75) == (0.0,) * 11
    p, bt = torch.as_tensor(pos), torch.as_tensor(box, dtype=torch.float32)
    dense = TFE(system, pair_kernel="dense", device="cpu")
    plist = TFE(system, box_hint=box, pos_hint=pos, pair_ts=32, device="cpu")
    band = TFE(system, box_hint=box, pos_hint=pos, pair_ts=32,
               fold_exc14=True, device="cpu")
    assert plist.pairs.mode == "plist" and band.pairs.mode == "band"
    assert band.pairs.carries_cache
    for want_energy in (True, False):
        td, fd = dense.energy_forces(p, bt, want_energy=want_energy)
        for ev in (plist, band):
            te, fe = ev.energy_forces(p, bt, want_energy=want_energy)
            assert_forces_close(fe.numpy(), fd.numpy())
            if want_energy:
                for k in ("lj", "coul_direct", "coul_excl_corr"):
                    np.testing.assert_allclose(float(te[k]), float(td[k]),
                                               rtol=5e-5, atol=1e-3,
                                               err_msg=k)
    assert abs(float(td["lj"])) > 1.0


# ------------------------------------ kernel B2's layout and column skip
def _sorted_layout(tables, pos, box, q, ts, inner_order=True):
    tc = tpt.make_pair_cache(_t(pos), _t(box), q, tables, ts,
                             inner_order=inner_order)
    n = pos.shape[0]
    pos2d = np.concatenate([pos, np.full((tc.perm.shape[0] - n, 3), 1e6,
                                         np.float32)])[tc.perm.numpy()]
    return tc, pos2d


def test_inner_order_keeps_jax_tiles_and_coverage():
    """inner_order=True reorders slots inside each z-sorted tile in strips
    along x that run along y: every tile holds the same atoms as the JAX cache's,
    pads stay last, the coverage flag is the JAX one on fresh, stale and
    undersized bands, the sweep gives the z order's forces and energies, and
    the host mirror of the layout is the device's."""
    tables, pos, box, q = _system(384, seed=4, has14=True)
    jq = jnp.asarray(q)
    stale = pos.copy()
    stale[:400, 2] += 4.0
    for cache_pos, band_w, want in ((pos, 3, False), (stale, 3, True),
                                    (pos, 1, True)):
        jc = jax.jit(lambda p: jpp.make_pair_cache(p, box, jq, tables, 128))(
            jnp.asarray(cache_pos))
        tc = tpt.make_pair_cache(_t(cache_pos), _t(box), q, tables, 128,
                                 inner_order=True)
        pj = np.asarray(jc.perm).reshape(-1, 128)
        pt_ = tc.perm.numpy().reshape(-1, 128)
        assert not np.array_equal(pj, pt_)
        np.testing.assert_array_equal(np.sort(pj, axis=1),
                                      np.sort(pt_, axis=1))
        n = pos.shape[0]
        last = pt_[(n - 1) // 128]
        assert (last[:n % 128 or 128] < n).all()
        np.testing.assert_array_equal(tc.invperm.numpy()[tc.perm.numpy()],
                                      np.arange(pt_.size))
        np.testing.assert_array_equal(
            tpt.band_layout_np(cache_pos, box, 128), tc.perm.numpy())
        np.testing.assert_array_equal(
            tpt.band_layout_np(cache_pos, box, 128, inner_order=False),
            np.asarray(jc.perm))
        flag_j = bool(jpp.band_coverage_bad(jnp.asarray(pos), box, jc, 128,
                                            band_w, RC))
        flag_t = bool(tpt.band_coverage_bad(_t(pos), _t(box), tc, 128,
                                            band_w, RC))
        assert flag_t == flag_j == want
    # a chunk of 32 slots is a patch of its slab, not a sheet across it
    tc, pos2d = _sorted_layout(tables, pos, box, q, 128)
    tz, pos2z = _sorted_layout(tables, pos, box, q, 128, inner_order=False)
    real = tc.ljt.numpy() >= 0

    def mean_xy_extent(p, r):
        half = tpt._chunk_boxes_np(p.astype(np.float64), r, box)[1]
        return half[:-1, :2].mean()

    assert mean_xy_extent(pos2d, real) < 0.8 * mean_xy_extent(
        pos2z, tz.ljt.numpy() >= 0)
    args = lambda c, p: (_t(p), c.q, c.ab, c.bits, c.bits14, c.oid, c.ljt,
                         c.grp, c.grows, _t(box))
    kw = dict(ts=128, t_dim=tables["arows"].shape[1], beta=BETA, r_cutoff=RC,
              has14=True, band_w=3)
    rows_i, col_i = tpt.run_tri(*args(tc, pos2d), **kw)
    rows_z, col_z = tpt.run_tri(*args(tz, pos2z), **kw)
    f_i = (rows_i[:, :3] + col_i[:3].t())[tc.invperm]
    f_z = (rows_z[:, :3] + col_z[:3].t())[tz.invperm]
    assert_forces_close(f_i.numpy(), f_z.numpy())
    for c in range(3, 8):
        np.testing.assert_allclose(float(rows_i[:, c].double().sum()),
                                   float(rows_z[:, c].double().sum()),
                                   rtol=5e-5, atol=1e-3)


def test_chunk_pair_map_marks_every_excluded_and_14_pair():
    """The bitmap against a brute-force walk of the masks, on the sorted
    and the unsorted layout: a chunk pair is marked exactly where it holds
    an excluded or folded 1-4 pair, or is a chunk with itself."""
    tables, pos, box, q = _system(96, seed=7, has14=True)
    tc, _ = _sorted_layout(tables, pos, box, q, 64)
    st = tpt.band_statics(q, tables, tc.perm.shape[0], "cpu")
    n_pad = tc.perm.shape[0]
    for cmap, ids, marks in (
            (tc.cmap, tc.perm.numpy(), (tc.bits | tc.bits14).numpy()),
            (st["cmap"], np.arange(n_pad),
             (st["bits"] | st["bits14"]).numpy())):
        got = tpt.chunk_pair_marked(cmap).numpy()
        inv = np.empty(n_pad, np.int64)
        inv[ids] = np.arange(n_pad)
        want = np.eye(n_pad // 32, dtype=bool)
        n_marks = 0
        for s in range(n_pad):
            for d in range(1, 32):
                if (int(marks[s]) >> d) & 1 and ids[s] + d < n_pad:
                    p = inv[ids[s] + d]
                    want[s // 32, p // 32] = want[p // 32, s // 32] = True
                    n_marks += 1
        assert n_marks >= 96 * 6
        np.testing.assert_array_equal(got, want)
        assert cmap.dtype == torch.int32 and cmap.shape == (
            n_pad // 32, -(-(n_pad // 32) // 32))


def _must_visit(pos2d, real, box, ids, marks, ts, mode, band_w, full):
    """(n_pad, n_pad) bool: the ordered (row, column) pairs of one
    enumeration that a sweep must evaluate: both real, distinct, and within
    the cutoff under the minimum image or excluded / 1-4 partners."""
    n_pad = pos2d.shape[0]
    n_tiles = n_pad // ts
    enum = np.zeros((n_tiles, n_tiles), bool)
    ti, tj = tpt.tile_pairs(mode, n_tiles, band_w, full)
    enum[ti, tj] = True
    d = pos2d[:, None, :].astype(np.float64) - pos2d[None, :, :]
    d -= box * np.round(d / box)
    need = (d * d).sum(-1) < RC * RC
    inv = np.empty(n_pad, np.int64)
    inv[ids] = np.arange(n_pad)
    partners = np.zeros((n_pad, n_pad), bool)
    for s in range(n_pad):
        for k in range(1, 32):
            if (int(marks[s]) >> k) & 1 and ids[s] + k < n_pad:
                p = inv[ids[s] + k]
                partners[s, p] = partners[p, s] = True
    need |= partners
    need &= real[:, None] & real[None, :] & ~np.eye(n_pad, dtype=bool)
    tile = np.arange(n_pad) // ts
    return need & enum[tile[:, None], tile[None, :]], partners


@pytest.mark.parametrize("case", ["has14", "groups", "beyond_cutoff",
                                  "full_sweep", "band+far"])
def test_skip_model_drops_no_pair(case):
    """The numpy model of kernel B2's two skips (chunk boxes, then columns
    against the row chunk's box; marked chunk pairs left alone) evaluates
    every pair of the enumeration that lies within the cutoff and every
    excluded or folded 1-4 pair at any distance, and skips most of the
    rest.  ``beyond_cutoff`` moves each molecule's last atom 2.5 nm along
    x, so its excluded and 1-4 partners lie beyond the cutoff and the patch
    size: only the bitmap keeps them."""
    has14 = case != "groups"
    tables, pos, box, q = _system(384, has14=has14, groups=case == "groups")
    pos = pos.copy()
    if case == "beyond_cutoff":
        pos[3::4, 0] += 2.5
    ts = 128
    mode, band_w, full = "bandall", 3, False
    if case == "full_sweep":
        band_w, full = 6, True
    n_pad = tpt.padded_size(pos.shape[0], ts)
    if case == "band+far":
        st = tpt.band_statics(q, tables, n_pad, "cpu")
        pos2d = np.concatenate([pos, np.full((n_pad - pos.shape[0], 3), 1e6,
                                             np.float32)])
        ids, cmap = np.arange(n_pad), st["cmap"]
        marks = (st["bits"] | st["bits14"]).numpy()
        real = st["ljt"].numpy() >= 0
        enums = [("band", 0, False, True), ("far", 0, False, False)]
    else:
        tc, pos2d = _sorted_layout(tables, pos, box, q, ts)
        ids, cmap = tc.perm.numpy(), tc.cmap
        marks = (tc.bits | tc.bits14).numpy()
        real = tc.ljt.numpy() >= 0
        enums = [(mode, band_w, full, True)]
    marked = tpt.chunk_pair_marked(cmap).numpy()
    for mode, band_w, full, use_map in enums:
        visited = np.zeros((n_pad, n_pad), bool)
        items, evals = tpt.skip_model_np(
            pos2d, real, box, marked if use_map else None, ts, RC, mode=mode,
            band_w=band_w, full_sweep=full, visited=visited)
        need, partners = _must_visit(pos2d, real, box, ids, marks, ts, mode,
                                     band_w, full)
        if not use_map:
            assert not (need & partners).any()   # far: no excluded pair
        else:
            assert int((need & partners).sum()) >= 384 * 6
        assert need.sum() > 1000
        assert not (need & ~visited).any()
        if case == "beyond_cutoff":
            far = partners & (np.abs(pos2d[:, None, 0] - pos2d[None, :, 0])
                              > 2.0) & need
            assert far.sum() >= 384 * 3 and not (far & ~visited).any()
        slots = len(tpt.tile_pairs(mode, n_pad // ts, band_w, full)[0]) \
            * ts * ts
        assert int(visited.sum()) <= evals <= slots
        # the unsorted layout's chunks span the box: little to skip there
        if case != "band+far":
            assert evals < 0.8 * slots, (evals, slots)
        assert items <= slots // 1024
