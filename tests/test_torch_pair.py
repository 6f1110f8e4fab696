"""Parity of the port's pair machinery with the JAX package: the dense
sweep, the plist cache (bit-identical), and the plist sweep's plain torch
version against the Pallas kernel B1 run in interpret mode."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openmm_velocityverlet_tpu.ops import allpairs as jap
from openmm_velocityverlet_tpu.ops import pallas_pair as jpp
from openmm_velocityverlet_tpu_torch.ops import allpairs as tap
from openmm_velocityverlet_tpu_torch.ops import pair_plist as tpp
from tests.test_pallas import _grid_mol_system, _mol_system

BETA, RC = 2.2, 1.2
# the JAX package's own pair-sweep tolerances (tests/test_pallas.py:179-182)
E_RTOL, E_ATOL = 5e-5, 0.05
F_RTOL, F_ATOL = 1e-3, 5e-2


def _system(kind, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "grid":
        lj_type, a, b, excl, pos, box, q = _grid_mol_system(rng)
    else:
        lj_type, a, b, excl, pos, box, q = _mol_system(384, rng)
    tables = jap.build_pair_tables(len(lj_type), lj_type, a, b, excl,
                                   fold_exc14=False)
    return tables, pos.astype(np.float32), box, q.astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def test_build_pair_tables_identical():
    tables, *_ = _system("mol")
    rng = np.random.default_rng(3)
    lj_type, a, b, excl, *_ = _mol_system(384, rng)
    mine = tap.build_pair_tables(len(lj_type), lj_type, a, b, excl,
                                 fold_exc14=False)
    for k, v in tables.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
        else:
            assert mine[k] == v, k


@pytest.mark.parametrize("kind", ["mol", "grid"])
def test_direct_space_dense_matches_jax(kind):
    tables, pos, box, q = _system(kind)
    ref = jap.direct_space_dense(jnp.asarray(pos), box, jnp.asarray(q),
                                 tables, BETA, RC, 256)
    got = tap.direct_space_dense(_t(pos), _t(box), _t(q), tables, BETA, RC,
                                 256)
    for x, y in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(float(y), float(x), rtol=E_RTOL,
                                   atol=E_ATOL)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]),
                               rtol=F_RTOL, atol=F_ATOL)


def test_pfit_coefficients_equal():
    for beta, rc in ((BETA, RC), (2.19, 1.2), (3.1, 0.9)):
        assert tpp._pfit_scaled(beta, rc) == jpp._pfit_scaled(beta, rc)


def _caches(kind, sort, nowrap=(False, False, False), shift=None):
    tables, pos, box, q = _system(kind)
    if shift is not None:
        pos = pos + shift
    cnt = jpp.count_candidates_np(pos, box, 128, RC + 0.1, mode=sort)
    assert cnt == tpp.count_candidates_np(pos, box, 128, RC + 0.1, mode=sort)
    cap = int(cnt * 1.6) + 16
    jc = jax.jit(lambda p, qq: jpp.make_pair_cache(
        p, box, qq, tables, 128, mode=sort, cap=cap, rc_cand=RC + 0.1,
        nowrap=nowrap))(jnp.asarray(pos), jnp.asarray(q))
    tc = tpp.make_pair_cache(_t(pos), _t(box), q, tables, 128, mode=sort,
                             cap=cap, rc_cand=RC + 0.1, nowrap=nowrap)
    return tables, pos, box, q, cap, jc, tc


@pytest.mark.parametrize("kind,sort,nowrap", [
    ("mol", "z", (False, False, False)),
    ("mol", "morton", (False, False, False)),
    ("grid", "z", (False, False, True)),
    ("mol", "z", (True, False, True)),      # frame budget fails: overflow
])
def test_make_pair_cache_bit_identical(kind, sort, nowrap):
    _, _, _, _, cap, jc, tc = _caches(kind, sort, nowrap)
    np.testing.assert_array_equal(tc.perm.numpy(), np.asarray(jc.perm))
    np.testing.assert_array_equal(tc.invperm.numpy(), np.asarray(jc.invperm))
    np.testing.assert_array_equal(tc.plist.numpy(), np.asarray(jc.plist))
    np.testing.assert_array_equal(tc.cand.numpy(), np.asarray(jc.cand))
    assert bool(tc.overflow) == bool(jc.overflow)
    np.testing.assert_array_equal(tc.ab2.numpy(), np.asarray(jc.ab2))
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q2d)[:, 0])
    np.testing.assert_array_equal(tc.bits.numpy(),
                                  np.asarray(jc.bits2d)[:, 0])
    # the index form of the one-hot column table
    oh = np.asarray(jc.oh2T)
    ljt = np.where(oh.sum(0) > 0, oh.argmax(0), -1)
    np.testing.assert_array_equal(tc.ljt.numpy(), ljt)


def test_make_pair_cache_overflow_flag():
    tables, pos, box, q = _system("mol", seed=4)
    jc = jax.jit(lambda p, qq: jpp.make_pair_cache(
        p, box, qq, tables, 128, mode="morton", cap=3, rc_cand=RC + 0.1))(
        jnp.asarray(pos), jnp.asarray(q))
    tc = tpp.make_pair_cache(_t(pos), _t(box), q, tables, 128,
                             mode="morton", cap=3, rc_cand=RC + 0.1)
    assert bool(jc.overflow) and bool(tc.overflow)
    np.testing.assert_array_equal(tc.plist.numpy(), np.asarray(jc.plist))


@pytest.mark.parametrize("kind,sort,want_energy,r_switch", [
    ("mol", "morton", True, 0.0), ("mol", "z", False, 0.0),
    ("grid", "z", True, 0.0), ("grid", "morton", False, 0.0),
    ("grid", "z", False, 0.9)])
def test_plist_reference_matches_pallas_interpret(kind, sort, want_energy,
                                                  r_switch):
    """The plain version of kernel B1 against the Pallas kernel itself:
    rows and colacc of one sweep over the same cache (with the LJ switch in
    the last case)."""
    nowrap = (False, False, True) if kind == "grid" and sort == "z" \
        else (False, False, False)
    tables, pos, box, q, cap, jc, tc = _caches(kind, sort, nowrap)
    n = pos.shape[0]
    pad = jc.perm.shape[0] - n
    pos2d = jnp.concatenate([jnp.asarray(pos),
                             jnp.full((pad, 3), 1e6, jnp.float32)])[jc.perm]
    rows_j, col_j = jpp._run_plist(
        jc.plist, pos2d, jc.q2d, jc.ab2, jc.bits2d,
        jc.perm.reshape(-1, 1), pos2d.T, jc.qT, jc.oh2T, jc.bitsT, jc.oidT,
        jnp.asarray(box), beta=BETA, r_cutoff=RC, ts=128, n_real=n,
        want_energy=want_energy, interpret=True, nowrap=nowrap,
        r_switch=r_switch)
    rows_t, col_t = tpp.sweep(
        tc, _t(np.asarray(pos2d)), _t(box), ts=128,
        t_dim=tables["arows"].shape[1], beta=BETA, r_cutoff=RC,
        r_switch=r_switch, nowrap=nowrap, want_energy=want_energy)
    rows_j, col_j = np.asarray(rows_j), np.asarray(col_j)
    np.testing.assert_allclose(rows_t[:, :3].numpy(), rows_j[:, :3],
                               rtol=F_RTOL, atol=F_ATOL)
    np.testing.assert_allclose(col_t.numpy(), col_j, rtol=F_RTOL,
                               atol=F_ATOL)
    for c in (3, 4, 5):
        np.testing.assert_allclose(float(rows_t[:, c].sum()),
                                   float(rows_j[:, c].sum()), rtol=E_RTOL,
                                   atol=E_ATOL)


@pytest.mark.parametrize("sort,want_energy,stale", [
    ("morton", True, False), ("z", False, False), ("z", True, True)])
def test_direct_space_plist_matches_jax(sort, want_energy, stale):
    """direct_space_plist against JAX direct_space_pallas(mode="plist",
    interpret=True, strict=False): energies, forces and the coverage flag
    (``stale`` builds the cache from positions a third of the box away, so
    the flag must trip on both sides)."""
    tables, pos, box, q = _system("mol", seed=5)
    cache_pos = pos.copy()
    if stale:
        cache_pos[:300 * 4, 2] += 4.0
    cnt = jpp.count_candidates_np(cache_pos, box, 128, RC + 0.1, mode=sort)
    cap = int(cnt * 1.6) + 16
    jc = jax.jit(lambda p, qq: jpp.make_pair_cache(
        p, box, qq, tables, 128, mode=sort, cap=cap, rc_cand=RC + 0.1))(
        jnp.asarray(cache_pos), jnp.asarray(q))
    tc = tpp.make_pair_cache(_t(cache_pos), _t(box), q, tables, 128,
                             mode=sort, cap=cap, rc_cand=RC + 0.1)
    ref = jpp.direct_space_pallas(
        jnp.asarray(pos), box, jnp.asarray(q), tables, BETA, RC, ts=128,
        interpret=True, mode="plist", plist_cap=cap, plist_sort=sort,
        want_energy=want_energy, cache=jc, with_flag=True, strict=False)
    got = tpp.direct_space_plist(
        _t(pos), _t(box), _t(q), tables, BETA, RC, 128,
        want_energy=want_energy, cache=tc, plist_cap=cap, plist_sort=sort)
    assert bool(got[6]) == bool(ref[6]) == stale
    if want_energy:
        for x, y in zip(ref[:3], got[:3]):
            np.testing.assert_allclose(float(y), float(x), rtol=E_RTOL,
                                       atol=E_ATOL)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]),
                               rtol=F_RTOL, atol=F_ATOL)


def test_direct_space_plist_residual_pairs():
    """Exclusions beyond the 31-offset window go through the residual
    adjustment on both sides."""
    rng = np.random.default_rng(0)
    n, T = 700, 5
    from tests.test_pallas import _random_tables
    lj_type, a, b, excl = _random_tables(n, T, rng, bandwidth=60)
    tables = jap.build_pair_tables(n, lj_type, a, b, excl, fold_exc14=False)
    assert tables["residual"].shape[0] > 0
    box = np.array([3.0, 3.0, 3.0], np.float32)
    pos = rng.uniform(0, 3.0, (n, 3)).astype(np.float32)
    q = rng.normal(0, 0.5, n).astype(np.float32)
    dense = tap.direct_space_dense(_t(pos), _t(box), _t(q), tables, BETA,
                                   RC, 256)
    cnt = tpp.count_candidates_np(pos, box, 128, RC + 0.1)
    got = tpp.direct_space_plist(_t(pos), _t(box), _t(q), tables, BETA, RC,
                                 128, plist_cap=int(cnt * 1.6) + 16)
    ref = jap.direct_space_dense(jnp.asarray(pos), box, jnp.asarray(q),
                                 tables, BETA, RC, 256)
    for x, y, z in zip(ref[:3], got[:3], dense[:3]):
        np.testing.assert_allclose(float(y), float(x), rtol=E_RTOL,
                                   atol=E_ATOL)
        np.testing.assert_allclose(float(z), float(x), rtol=E_RTOL,
                                   atol=E_ATOL)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]),
                               rtol=F_RTOL, atol=F_ATOL)


def test_strict_pairs_refused():
    """What the plist sweep still refuses, strict or not: folded 1-4
    exceptions (the JAX plist branch refuses them too,
    pallas_pair.py:1667-1670); they run in the band sweep.  strict=True
    itself now runs, with kernel B2's full sweep on a coverage trip
    (tests/test_torch_band.py holds it against the JAX package)."""
    from openmm_velocityverlet_tpu.units import ONE_4PI_EPS0
    rng = np.random.default_rng(7)
    lj_type, a, b, excl, pos, box, q = _mol_system(96, rng)
    n = len(lj_type)
    idx = np.full((n, 1), -1, np.int32)
    qq = np.zeros((n, 1), np.float32)
    for m in range(n // 4):
        i, j = 4 * m, 4 * m + 3
        idx[i, 0], idx[j, 0] = j, i
        qq[i, 0] = qq[j, 0] = ONE_4PI_EPS0 * 0.5 * q[i] * q[j]
    tables = jap.build_pair_tables(n, lj_type, a, b, excl, exc_idx=idx,
                                   exc_qq=qq, exc_c6=np.zeros_like(qq),
                                   exc_c12=np.zeros_like(qq) + 1e-6,
                                   charges=q)
    assert tables["has_exc14"]
    for strict in (False, True):
        with pytest.raises(NotImplementedError, match="fold"):
            tpp.direct_space_plist(_t(pos), _t(box), _t(q), tables, BETA, RC,
                                   128, plist_cap=64, strict=strict)
    plain, pos, box, q = _system("mol")
    got = tpp.direct_space_plist(_t(pos), _t(box), _t(q), plain, BETA, RC,
                                 128, plist_cap=64, strict=True)
    assert isinstance(got[6], bool)
