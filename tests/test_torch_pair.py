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


def assert_forces_close(got, ref, rtol=F_RTOL, atol=F_ATOL):
    """Per-atom force comparison: atom i's components must lie within
    ``atol + rtol * max_c |ref[i, c]|`` of the reference.

    The random fixtures of tests/test_pallas.py (``_mol_system``,
    ``_grid_mol_system``) overlap atoms (the closest pair is ~0.006 nm
    apart), so many atoms carry force components above 1e4 kJ/mol/nm.  A
    small component of such an atom is the float32 sum of ~1e5-size terms
    that cancel: its value depends on the order of the summation (which
    differs between libraries, and with the number of threads of the day),
    not on the algorithm.  The relative part of the tolerance therefore
    scales with the atom's largest component, not with each element."""
    got = np.asarray(got, np.float64).reshape(-1, 3)
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    assert got.shape == ref.shape
    tol = atol + rtol * np.abs(ref).max(axis=1, keepdims=True)
    err = np.abs(got - ref)
    bad = err > tol
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} force components beyond "
        f"atol {atol} + rtol {rtol} * max|F_atom|; worst excess "
        f"{float((err - tol).max()):.3e} at atom "
        f"{int(np.argmax((err - tol).max(axis=1)))}")


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
    assert_forces_close(got[5].numpy(), np.asarray(ref[5]))


def test_pfit_coefficients_equal():
    for beta, rc in ((BETA, RC), (2.19, 1.2), (3.1, 0.9)):
        assert tpp._pfit_scaled(beta, rc) == jpp._pfit_scaled(beta, rc)


def _caches(kind, sort, nowrap=(False, False, False), shift=None, ts=128):
    tables, pos, box, q = _system(kind)
    if shift is not None:
        pos = pos + shift
    cnt = jpp.count_candidates_np(pos, box, ts, RC + 0.1, mode=sort)
    assert cnt == tpp.count_candidates_np(pos, box, ts, RC + 0.1, mode=sort)
    cap = int(cnt * 1.6) + 16
    jc = jax.jit(lambda p, qq: jpp.make_pair_cache(
        p, box, qq, tables, ts, mode=sort, cap=cap, rc_cand=RC + 0.1,
        nowrap=nowrap))(jnp.asarray(pos), jnp.asarray(q))
    tc = tpp.make_pair_cache(_t(pos), _t(box), q, tables, ts, mode=sort,
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


@pytest.mark.parametrize("ts", [32, 64])
@pytest.mark.parametrize("kind,sort,nowrap", [
    ("mol", "morton", (False, False, False)),
    ("grid", "z", (False, False, True))])
def test_make_pair_cache_small_tiles_bit_identical(kind, sort, nowrap, ts):
    """The warp-sized tiles kernel B1 admits (32 and 64 atoms): the JAX
    ``make_pair_cache`` takes them on the CPU too, and the port's list,
    sort and flags stay bit for bit its; the nowrap axes, the candidate
    count and the coverage check agree as at 128."""
    assert tpp.nowrap_axes_np(*_system(kind)[1:3], ts, RC + 0.1, mode=sort) \
        == jpp.nowrap_axes_np(*_system(kind)[1:3], ts, RC + 0.1, mode=sort)
    _, pos, box, _, cap, jc, tc = _caches(kind, sort, nowrap, ts=ts)
    np.testing.assert_array_equal(tc.perm.numpy(), np.asarray(jc.perm))
    np.testing.assert_array_equal(tc.plist.numpy(), np.asarray(jc.plist))
    np.testing.assert_array_equal(tc.cand.numpy(), np.asarray(jc.cand))
    np.testing.assert_array_equal(tc.ab2.numpy(), np.asarray(jc.ab2))
    assert bool(tc.overflow) == bool(jc.overflow) is False
    n = pos.shape[0]
    pad = tc.perm.shape[0] - n
    pos2d = np.concatenate([pos, np.full((pad, 3), 1e6, np.float32)]
                           )[tc.perm.numpy()]
    for moved in (pos2d, pos2d + np.float32(0.4) * (pos2d < 1e5)
                  * np.sin(np.arange(pos2d.shape[0]))[:, None]):
        bad_t = tpp.plist_coverage_bad(_t(moved), _t(box), tc, ts, RC,
                                       nowrap=nowrap)
        bad_j = jpp.plist_coverage_bad(jnp.asarray(moved, jnp.float32),
                                       jnp.asarray(box), jc, ts, RC,
                                       nowrap=nowrap)
        assert bool(bad_t) == bool(bad_j)


@pytest.mark.parametrize("ts", [32, 64, 128, 384])
def test_slice_blocks_cover_every_entry_once(ts):
    """Kernel B1's blocks: each row tile's entries cut into slices of
    ``slice_entries(ts)``, every active entry in exactly one block, blocks of
    a tile contiguous in ``blk_ptr``; an overflowing list (cap 3) too."""
    tables, pos, box, q = _system("mol")
    cnt = tpp.count_candidates_np(pos, box, ts, RC + 0.1)
    for cap in (int(cnt * 1.6) + 16, 3):
        c = tpp.make_pair_cache(_t(pos), _t(box), q, tables, ts, cap=cap,
                                rc_cand=RC + 0.1)
        s = tpp.slice_entries(ts)
        n_tiles = c.perm.shape[0] // ts
        blk_tile, blk_e0, blk_ptr = (x.numpy() for x in (
            c.blk_tile, c.blk_e0, c.blk_ptr))
        row_ptr, plist = c.row_ptr.numpy(), c.plist.numpy()
        assert blk_tile.shape == blk_e0.shape == (cap // s + n_tiles,)
        seen = np.zeros(cap, int)
        for b, (t, e0) in enumerate(zip(blk_tile, blk_e0)):
            if t < 0:
                assert b >= blk_ptr[-1]
                continue
            assert blk_ptr[t] <= b < blk_ptr[t + 1]
            e1 = min(e0 + s, row_ptr[t + 1])
            assert row_ptr[t] <= e0 < e1
            assert ((plist[e0:e1] & 1) == 1).all()
            assert ((plist[e0:e1] >> 17) == t).all()
            seen[e0:e1] += 1
        np.testing.assert_array_equal(seen, (plist & 1))


def _skip_model(pos_sorted, box, cache, ts, rc, nowrap, excl_bits):
    """Float64 model of kernel B1's column skip (csrc/plist_pair.cu): for
    every active entry and every chunk of 32 rows, the columns it keeps.
    Returns (kept pair evaluations, pairs in reach, dropped pairs in reach):
    a pair is in reach if it lies within the cutoff under the minimum image
    (in the kernel's frame on nowrap axes) or is excluded by the 31-offset
    mask."""
    pos = np.asarray(pos_sorted, np.float64)
    box = np.asarray(box, np.float64)
    oid = cache.oid.numpy().astype(np.int64)
    ljt = cache.ljt.numpy()
    n = excl_bits.shape[0]
    words = cache.plist.numpy()
    words = words[(words & 1) == 1].astype(np.int64)
    kept = reach = dropped = 0

    def wrap(a, c0, L):
        return a - L * np.round((a - c0) / L)

    for w in words:
        ti, tj, flagged = w >> 17, (w >> 3) & 0x3FFF, bool(w & 2)
        for rc_ in range(ts // 32):
            r = slice(ti * ts + rc_ * 32, ti * ts + rc_ * 32 + 32)
            c = slice(tj * ts, tj * ts + ts)
            pr, pc = pos[r].copy(), pos[c].copy()
            gap2 = np.zeros(ts)
            d = np.zeros((32, ts, 3))
            for ax in range(3):
                L = box[ax]
                frame = pos[ti * ts, ax] if nowrap[ax] else pr[0, ax]
                pr[:, ax] = wrap(pr[:, ax], frame, L)
                if nowrap[ax]:
                    pc[:, ax] = wrap(pc[:, ax], frame, L)
                m = 0.5 * (pr[:, ax].min() + pr[:, ax].max())
                h = 0.5 * (pr[:, ax].max() - pr[:, ax].min()) + 1e-3
                u = pc[:, ax] - m
                u -= L * np.round(u / L)
                gap2 += np.maximum(np.abs(u) - h, 0.0) ** 2
                dd = pr[:, None, ax] - pc[None, :, ax]
                d[:, :, ax] = dd if nowrap[ax] else dd - L * np.round(dd / L)
            keep = gap2 <= rc * rc * 1.0001
            if flagged:
                keep |= (oid[c] >= oid[r].min() - 31) \
                    & (oid[c] <= oid[r].max() + 31)
            keep &= ljt[c] >= 0
            delta = oid[c][None, :] - oid[r][:, None]
            lo = np.minimum(oid[r][:, None], oid[c][None, :])
            dabs = np.abs(delta)
            bits = excl_bits[np.clip(lo, 0, n - 1)]
            excl = (dabs >= 1) & (dabs <= 31) & (lo < n) \
                & (((bits >> np.clip(dabs, 0, 31)) & 1) == 1)
            real = (ljt[r] >= 0)[:, None] & (ljt[c] >= 0)[None, :]
            need = real & (delta != 0) & (((d * d).sum(-1) < rc * rc) | excl)
            kept += 32 * int(keep.sum())
            reach += int(need.sum())
            dropped += int((need & ~keep[None, :]).sum())
            if excl.any():
                assert flagged, "an excluded pair in an unflagged entry"
    return kept, reach, dropped


@pytest.mark.parametrize("ts", [32, 64])
@pytest.mark.parametrize("kind,sort,nowrap", [
    ("mol", "morton", (False, False, False)),
    ("grid", "z", (False, False, True))])
def test_column_skip_model_drops_no_pair(kind, sort, nowrap, ts):
    """The column skip of kernel B1, modelled in float64 on the wrapped and
    on the nowrap frame: no pair within the cutoff and no excluded pair is
    dropped, and the skip does cut the work (the evaluations kept are
    fewer than the list's ts x ts slots)."""
    tables, pos, box, q, cap, _, tc = _caches(kind, sort, nowrap, ts=ts)
    n = pos.shape[0]
    pad = tc.perm.shape[0] - n
    pos2d = np.concatenate([pos, np.full((pad, 3), 1e6, np.float32)]
                           )[tc.perm.numpy()]
    kept, reach, dropped = _skip_model(
        pos2d, box, tc, ts, RC, nowrap,
        np.asarray(tables["excl_bits"]).astype(np.int64))
    entries = int((tc.plist.numpy() & 1).sum())
    slots = entries * ts * ts
    # ForceEvaluator's cost model of the skip: the same test without the
    # nowrap frame and the exclusion rule, in the kernel's rounds of four
    # columns
    n_ent, evals = tpp.count_evaluations_np(pos, box, ts, RC + 0.1, RC,
                                            mode=sort)
    print(f"\n[{kind} ts={ts}] slots {slots}, kept {kept}, in reach {reach},"
          f" modelled evaluations {evals}")
    assert dropped == 0 and reach > 0
    assert reach <= kept < slots
    assert n_ent == entries
    # (a round of four columns adds at most 3 x 32 evaluations an item)
    assert 0.9 * kept <= evals <= 1.05 * kept \
        + 96 * entries * (ts // 32) ** 2


@pytest.mark.parametrize("ts", [32, 64])
@pytest.mark.parametrize("kind", ["mol", "grid"])
@pytest.mark.parametrize("want_energy", [True, False])
def test_plist_small_tiles_match_dense(kind, ts, want_energy):
    """``plist_pair_reference`` over a ``make_pair_cache`` list at the
    warp-sized tiles (32 and 64 atoms) against the port's dense sweep:
    energies and per-atom forces."""
    tables, pos, box, q = _system(kind)
    dense = tap.direct_space_dense(_t(pos), _t(box), _t(q), tables, BETA, RC,
                                   256)
    sort = "z" if kind == "grid" else "morton"
    nowrap = tpp.nowrap_axes_np(pos, box, ts, RC + 0.1, mode=sort)
    cnt = tpp.count_candidates_np(pos, box, ts, RC + 0.1, mode=sort)
    got = tpp.direct_space_plist(
        _t(pos), _t(box), _t(q), tables, BETA, RC, ts,
        want_energy=want_energy, plist_cap=int(cnt * 1.6) + 16,
        plist_sort=sort, nowrap=nowrap)
    assert not bool(got[6])
    if want_energy:
        for x, y in zip(dense[:3], got[:3]):
            np.testing.assert_allclose(float(y), float(x), rtol=E_RTOL,
                                       atol=E_ATOL)
    assert_forces_close(got[5].numpy(), dense[5].numpy())


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
    assert_forces_close(rows_t[:, :3].numpy(), rows_j[:, :3])
    np.testing.assert_allclose(col_t[3:].numpy(), col_j[3:], rtol=F_RTOL,
                               atol=F_ATOL)
    assert_forces_close(col_t[:3].numpy().T, col_j[:3].T)
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
    assert_forces_close(got[5].numpy(), np.asarray(ref[5]))


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
    assert_forces_close(got[5].numpy(), np.asarray(ref[5]))


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
