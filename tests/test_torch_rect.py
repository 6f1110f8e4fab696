"""Parity of the port's tiled direct-space entry point with the JAX
package: the plain version of kernel B3 (``pair_rect.rect_pair_reference``)
against the Pallas ``_run`` in interpret mode, and every branch of
``pair_direct.direct_space_tiled`` against ``direct_space_pallas`` with the
same arguments (interpret mode): the rectangular sweep (with and without
interaction groups, with exclusions beyond the 31-offset window, with an LJ
switch), the plist sweep, the z band and the unsorted upper triangle.

Tolerances are the JAX package's own (tests/test_pallas.py:53-56): energies
rtol 2e-5, forces rtol 1e-3 / atol 5e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_velocityverlet_tpu.ops import allpairs as jap
from openmm_velocityverlet_tpu.ops import pallas_pair as jpp
from openmm_velocityverlet_tpu_torch.ops import pair_rect as tpr
from openmm_velocityverlet_tpu_torch.ops import pair_tri as tpt
from openmm_velocityverlet_tpu_torch.ops.pair_direct import \
    direct_space_tiled
from tests.test_pallas import _mol_system, _random_tables
from tests.test_torch_pair import assert_forces_close

BETA, RC = 2.2, 1.2
E_RTOL = 2e-5
F_RTOL, F_ATOL = 1e-3, 5e-2


def _random_system(use_groups, bandwidth, seed=0):
    """The fixture of tests/test_pallas.py:32-47: n=700, T=5, a 3 nm box."""
    rng = np.random.default_rng(seed)
    n, T = 700, 5
    lj_type, a, b, excl = _random_tables(n, T, rng, bandwidth=bandwidth)
    lj_group = rng.integers(0, 2, n) if use_groups else None
    allowed = np.array([[True, True], [True, False]]) if use_groups else None
    tables = jap.build_pair_tables(n, lj_type, a, b, excl, lj_group, allowed)
    box = np.array([3.0, 3.0, 3.0], np.float32)
    pos = rng.uniform(0, 3.0, (n, 3)).astype(np.float32)
    q = rng.normal(0, 0.5, n).astype(np.float32)
    return tables, pos, box, q


def _compare(got, ref):
    for x, y in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(float(y), float(x), rtol=E_RTOL)
    for x, y in zip(ref[3:5], got[3:5]):
        np.testing.assert_allclose(float(y), float(x), rtol=E_RTOL,
                                   atol=1e-6)
    assert_forces_close(got[5].numpy(), np.asarray(ref[5]))


@pytest.mark.parametrize("use_groups", [False, True])
def test_rect_pair_reference_matches_pallas_run(use_groups):
    """The plain version of B3 against the Pallas ``_run`` on the same
    padded operands: per-row forces, and each energy column's sum (the
    kernel counts every pair from both sides)."""
    tables, pos, box, q = _random_system(use_groups, 8)
    n, blk = pos.shape[0], 128
    n_pad = tpt.padded_size(n, blk)
    pad = n_pad - n
    q2d, ab, bits2d, _, onehot2d, grows, gonehot2d = jpp._padded_statics(
        n, pad, jnp.asarray(q), tables)
    pos2d = np.concatenate([pos, np.full((pad, 3), 1e6, np.float32)])
    ref = np.asarray(jpp._run(
        jnp.asarray(pos2d), q2d, ab, bits2d, grows, jnp.asarray(pos2d).T,
        q2d.T, onehot2d.T, bits2d.T, gonehot2d.T, jnp.asarray(box), BETA, RC,
        blk, blk, n, interpret=True))
    st = tpt.band_statics(q, tables, n_pad, "cpu")
    got = tpr.rect_pair_reference(
        torch.as_tensor(pos2d), st["q"], st["ab"], st["bits"], st["ljt"],
        st["grp"], st["grows"], torch.as_tensor(box), n=n,
        t_dim=tables["arows"].shape[1], beta=BETA, r_cutoff=RC).numpy()
    assert got.shape == ref.shape == (n_pad, 8)
    np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=F_RTOL,
                               atol=F_ATOL)
    for c in (3, 4, 5):
        np.testing.assert_allclose(got[:, c].sum(), ref[:, c].sum(),
                                   rtol=E_RTOL)
    assert not got[n:].any() and not got[:, 6:].any()
    # run_rect pads and builds the same operands itself
    np.testing.assert_array_equal(
        tpr.run_rect(torch.as_tensor(pos), torch.as_tensor(box), q, tables,
                     beta=BETA, r_cutoff=RC, blk=blk).numpy(), got)


@pytest.mark.parametrize("use_groups,bandwidth,r_switch", [
    (False, 8, 0.0), (True, 8, 0.0), (False, 60, 0.0), (True, 8, 1.0)])
def test_rectangular_branch_matches_jax(use_groups, bandwidth, r_switch):
    """``symmetric=False`` at tm = tn = 128; bandwidth 60 puts exclusions
    beyond the 31-offset window (the residual adjustment); r_switch 1.0
    runs the LJ switch."""
    tables, pos, box, q = _random_system(use_groups, bandwidth)
    assert (tables["residual"].shape[0] > 0) == (bandwidth > 31)
    ref = jpp.direct_space_pallas(
        jnp.asarray(pos), box, jnp.asarray(q), tables, BETA, RC, tm=128,
        tn=128, ts=128, interpret=True, symmetric=False, r_switch=r_switch,
        with_flag=True)
    got = direct_space_tiled(
        torch.as_tensor(pos), torch.as_tensor(box), q, tables, BETA, RC,
        tm=128, tn=128, ts=128, symmetric=False, r_switch=r_switch,
        with_flag=True)
    _compare(got, ref)
    assert bool(got[6]) is False and bool(ref[6]) is False


def _mol(seed=3):
    rng = np.random.default_rng(seed)
    lj_type, a, b, excl, pos, box, q = _mol_system(384, rng)
    tables = jap.build_pair_tables(len(lj_type), lj_type, a, b, excl)
    return tables, pos.astype(np.float32), box, q.astype(np.float32)


@pytest.mark.parametrize("branch,kw", [
    ("plist", dict(mode="plist", plist_cap=80, plist_sort="morton")),
    ("band", dict(band_w=3)),
    ("upper_triangle", dict(band_w=0))])
@pytest.mark.parametrize("want_energy", [True, False])
def test_symmetric_branches_match_jax(branch, kw, want_energy):
    """The symmetric branches on the long-box molecular system of
    tests/test_pallas.py:60 (1,536 atoms, 12 tiles of 128): the tile-pair
    list, the z band (W = 3) and, with no band, the unsorted band + far
    sweep; with the JAX default strict=True."""
    tables, pos, box, q = _mol()
    ref = jpp.direct_space_pallas(
        jnp.asarray(pos), box, jnp.asarray(q), tables, BETA, RC, ts=128,
        interpret=True, want_energy=want_energy, with_flag=True, **kw)
    got = direct_space_tiled(
        torch.as_tensor(pos), torch.as_tensor(box), torch.as_tensor(q),
        tables, BETA, RC, ts=128, want_energy=want_energy, with_flag=True,
        **kw)
    if want_energy:
        _compare(got, ref)
    else:
        assert_forces_close(got[5].numpy(), np.asarray(ref[5]))
    assert bool(got[6]) == bool(ref[6]) is False
    assert len(direct_space_tiled(
        torch.as_tensor(pos), torch.as_tensor(box), q, tables, BETA, RC,
        ts=128, want_energy=want_energy, **kw)) == 6


def test_rectangular_branch_refuses_folded_exc14():
    tables, pos, box, q = _random_system(False, 8)
    tables = dict(tables, has_exc14=True)
    with pytest.raises(NotImplementedError, match="symmetric"):
        direct_space_tiled(torch.as_tensor(pos), torch.as_tensor(box), q,
                           tables, BETA, RC, symmetric=False)
