"""The port's fused exact-k reciprocal (ops/ewald_fused.py, kernels B4/B5
with their plain versions on the CPU) against the JAX package's
``ewald_pallas.reciprocal_energy_fused`` in interpret mode and against the
JAX matmul route ``ewald.reciprocal_energy``: the energy, the autograd
forces, and the zero box / charge gradients of the contract.  kmax is
asymmetric and N not a multiple of ts; the (12, 11, 13) case has
K = 7,762 > 2048 modes, so the 1024-wide k tiling runs.

Tolerances are tests/test_ewald_fused.py's: energy rtol 2e-5 (:36), forces
atol 3e-5 max|F| / rtol 2e-4 (:52-53)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_velocityverlet_tpu.ops import ewald as jew
from openmm_velocityverlet_tpu.ops import ewald_pallas as jep
from openmm_velocityverlet_tpu_torch.ops import ewald_fused as tef

BETA = 2.8
CASES = [(97, (3, 4, 6), 32), (150, (12, 11, 13), 64)]


def _system(n, seed):
    rng = np.random.default_rng(seed)
    box = np.array([2.1, 2.6, 3.4], np.float32)
    pos = (rng.uniform(0, 1, (n, 3)) * box).astype(np.float32)
    q = rng.normal(0, 1, n)
    q = (q - q.mean()).astype(np.float32)
    return pos, box, q


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


@pytest.mark.parametrize("n,kmax,ts", CASES)
def test_prep_matches_jax(n, kmax, ts):
    """K ordering, k tile, padding, weights and prefactor of _prep."""
    pos, box, q = _system(n, 11)
    ref = jep._prep(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(q),
                    BETA, kmax, ts)
    got = tef._prep(_t(pos), _t(box), _t(q), BETA, kmax, ts)
    assert got[5:] == tuple(ref[5:])
    assert (got[7] == 1024) == (tef.k_tiling(kmax)[0] > 2048)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1])[:, 0])
    for x, y in zip(got[2:5], ref[2:5]):
        y = np.asarray(y)
        np.testing.assert_allclose(np.asarray(x), y, rtol=1e-6,
                                   atol=1e-6 * np.abs(y).max())


@pytest.mark.parametrize("n,kmax,ts", CASES)
def test_fused_energy_and_forces_match_jax(n, kmax, ts):
    pos, box, q = _system(n, 12)
    jbox, jq = jnp.asarray(box), jnp.asarray(q)

    def e_fused(p):
        return jep.reciprocal_energy_fused(p, jbox, jq, BETA, kmax, ts, True)

    def e_matmul(p):
        return jew.reciprocal_energy(p, jbox, jq, BETA, kmax)

    e_j, g_j = jax.value_and_grad(e_fused)(jnp.asarray(pos))
    e_m, g_m = jax.value_and_grad(e_matmul)(jnp.asarray(pos))
    p = _t(pos).requires_grad_(True)
    e_t = tef.reciprocal_energy_fused(p, _t(box), _t(q), BETA, kmax, ts)
    (g_t,) = torch.autograd.grad(e_t, p)
    for ref, g_ref in ((e_j, g_j), (e_m, g_m)):
        np.testing.assert_allclose(float(e_t.detach()), float(ref),
                                   rtol=2e-5)
        scale = float(jnp.abs(g_ref).max())
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_ref),
                                   atol=3e-5 * scale, rtol=2e-4)


def test_fused_box_charge_gradients_are_zero_by_contract():
    """The backward propagates position gradients only; box and charge
    gradients are zero, as the JAX custom_vjp returns."""
    pos, box, q = _system(97, 13)
    b = _t(box).requires_grad_(True)
    c = _t(q).requires_grad_(True)
    p = _t(pos).requires_grad_(True)
    e = tef.reciprocal_energy_fused(p, b, c, BETA, (3, 4, 6), 32)
    g_p, g_b, g_c = torch.autograd.grad(e, (p, b, c))
    assert float(g_b.abs().max()) == 0.0 and float(g_c.abs().max()) == 0.0
    assert float(g_p.abs().max()) > 0.0
    jg_b = jax.grad(lambda bb: jep.reciprocal_energy_fused(
        jnp.asarray(pos), bb, jnp.asarray(q), BETA, (3, 4, 6), 32, True))(
        jnp.asarray(box))
    assert float(jnp.abs(jg_b).max()) == 0.0


@pytest.mark.parametrize("n,kmax,ts", [(97, (3, 4, 5), 32),
                                       (40, (20, 20, 20), 8)])
def test_factorised_forces_match_reference_and_jax(n, kmax, ts):
    """The algorithm of kernel B5 (per-atom phase tables multiplied out, the
    modes taken column by column through ``column_offsets``) in plain torch
    against the theta = k . r plain version and against the JAX ``_forces``
    in interpret mode, on ``(a_k, b_k)`` from a real structure factor.  This
    pins the order of the K list the kernel relies on: (20, 20, 20) is the
    19,500-atom system's grid (34,460 modes, tiled by 1024)."""
    pos, box, q = _system(n, 14)
    posp, qp, kvec, w, c0, n_pad, kp, kt = tef._prep(_t(pos), _t(box), _t(q),
                                                     BETA, kmax, ts)
    off = tef.column_offsets(kmax)
    k_real = tef.k_tiling(kmax)[0]
    assert off[-1] == k_real and off.shape[0] == \
        (2 * kmax[0] + 1) * (2 * kmax[1] + 1) + 1
    # every column is one (nx, ny), ascending in nz and ending at kmax_z
    modes = tef._half_space_modes(kmax)
    nys = 2 * kmax[1] + 1
    for c in range(off.shape[0] - 1):
        seg = modes[off[c]:off[c + 1]]
        assert (seg[:, 0] == c // nys - kmax[0]).all()
        assert (seg[:, 1] == c % nys - kmax[1]).all()
        assert seg.shape[0] in (kmax[2], kmax[2] + 1)
        assert seg[-1, 2] == kmax[2] and (np.diff(seg[:, 2]) == 1).all()
    s_re, s_im = tef.structure_factor(posp, qp, kvec, kmax, _t(box))
    ab = torch.stack([2.0 * c0 * w * s_im, 2.0 * c0 * w * s_re]).contiguous()
    assert not ab[:, k_real:].any()
    f_ref = tef.recip_forces_reference(posp, qp, kvec, ab)
    f_fac = tef.recip_forces_factorised(posp, qp, ab, kmax, _t(box))
    ab8 = jnp.zeros((8, kp), jnp.float32).at[:2].set(jnp.asarray(ab.numpy()))
    f_jax = np.asarray(jep._forces(
        jnp.asarray(posp.numpy()), jnp.asarray(qp.numpy())[:, None],
        jnp.asarray(kvec.numpy()), ab8, ts, kp, kt, n, True))
    scale = float(f_ref.abs().max())
    assert scale > 1.0
    np.testing.assert_allclose(f_fac.numpy(), f_ref.numpy(),
                               atol=3e-5 * scale, rtol=2e-4)
    np.testing.assert_allclose(f_fac.numpy()[:n], f_jax,
                               atol=3e-5 * scale, rtol=2e-4)
    # the public wrapper takes kmax and box and, on the CPU, the plain version
    np.testing.assert_array_equal(
        tef.recip_forces(posp, qp, kvec, ab, kmax, _t(box)).numpy(),
        f_ref.numpy())


@pytest.mark.parametrize("n,kmax,ts", [(97, (3, 4, 5), 32),
                                       (40, (20, 20, 20), 8)])
def test_factorised_structure_factor_matches_reference_and_jax(n, kmax, ts):
    """The algorithm of kernel B4 (per-atom axis tables, the dense (nx, ny,
    nz) block gathered into list order) in plain torch against the
    theta = k . r plain version and against the JAX ``_structure_factor``
    in interpret mode: every mode within float32 rounding of the sum's
    size, and the energy at rtol 2e-5."""
    pos, box, q = _system(n, 15)
    posp, qp, kvec, w, c0, n_pad, kp, kt = tef._prep(_t(pos), _t(box), _t(q),
                                                     BETA, kmax, ts)
    s_ref = tef.structure_factor_reference(posp, qp, kvec)
    s_fac = tef.structure_factor_factorised(posp, qp, kmax, _t(box))
    s8 = np.asarray(jep._structure_factor(
        jnp.asarray(posp.numpy()), jnp.asarray(qp.numpy())[:, None],
        jnp.asarray(kvec.numpy()), ts, kp, kt, True))
    scale = float(qp.abs().sum())

    def energy(s_re, s_im):
        return float(c0 * torch.sum(w.double() * (_t(s_re).double() ** 2
                                                  + _t(s_im).double() ** 2)))

    for c in range(2):
        np.testing.assert_allclose(s_fac[c].numpy(), s_ref[c].numpy(),
                                   atol=2e-5 * scale, rtol=0)
        np.testing.assert_allclose(s_fac[c].numpy(), s8[c],
                                   atol=2e-5 * scale, rtol=0)
    assert abs(energy(*s_ref)) > 1e-3
    np.testing.assert_allclose(energy(*s_fac), energy(*s_ref), rtol=2e-5)
    np.testing.assert_allclose(energy(*s_fac), energy(s8[0], s8[1]),
                               rtol=2e-5)
    # the public wrapper takes kmax and box and, on the CPU, the plain version
    got = tef.structure_factor(posp, qp, kvec, kmax, _t(box))
    np.testing.assert_array_equal(got[0].numpy(), s_ref[0].numpy())


def test_factorised_structure_factor_nz0_half_plane():
    """The nz = 0 plane: the list keeps only (ny > 0) | (ny == 0 & nx > 0).
    The dense block computes the other half too (it is the conjugate) and
    the gather drops it: no list entry takes a value from it, and every
    kept nz = 0 mode is the conjugate of its mirror in the dense block."""
    kmax = (3, 2, 4)
    pos, box, q = _system(33, 16)
    posp, qp, kvec, *_ = tef._prep(_t(pos), _t(box), _t(q), BETA, kmax, 8)
    k, live = tef._list_of_dense(kmax, "cpu")
    live = live.reshape(7, 5, 5)
    nx = torch.arange(-3, 4)[:, None]
    ny = torch.arange(-2, 3)[None, :]
    want0 = (ny > 0) | ((ny == 0) & (nx > 0))
    assert torch.equal(live[:, :, 0], want0) and bool(live[:, :, 1:].all())
    assert int(live.sum()) == tef.k_tiling(kmax)[0]
    assert torch.equal(torch.sort(k.reshape(7, 5, 5)[live]).values,
                       torch.arange(int(live.sum())))
    s_re, s_im = tef.structure_factor_factorised(posp, qp, kmax, _t(box))
    r_re, r_im = tef.structure_factor_reference(posp, qp, kvec)
    modes = tef._half_space_modes(kmax)
    plane = np.nonzero(modes[:, 2] == 0)[0]
    assert plane.size == int(want0.sum())
    scale = float(qp.abs().sum())
    np.testing.assert_allclose(s_re[plane].numpy(), r_re[plane].numpy(),
                               atol=2e-5 * scale)
    np.testing.assert_allclose(s_im[plane].numpy(), r_im[plane].numpy(),
                               atol=2e-5 * scale)


def test_factorised_structure_factor_pad_modes():
    """The pad modes k >= K (kvec 0, weight 0): the plain version gives
    sum_i q_i there, and so do the factorised model and kernel B4 (the dense
    block's (0, 0, 0) element); the kernel's map from its dense partial
    block to the list names every mode once, and (0, 0, 0) as the pads'."""
    kmax = (20, 20, 20)
    pos, box, q = _system(24, 17)
    q = q + np.float32(0.25)
    posp, qp, kvec, w, *_ = tef._prep(_t(pos), _t(box), _t(q), BETA, kmax, 8)
    k_real, _, kp = tef.k_tiling(kmax)
    assert kp > k_real and not w[k_real:].any()
    s_re, s_im = tef.structure_factor_factorised(posp, qp, kmax, _t(box))
    r_re, r_im = tef.structure_factor_reference(posp, qp, kvec)
    total = float(qp.sum())
    assert abs(total) > 1.0
    np.testing.assert_allclose(s_re[k_real:].numpy(), total, rtol=1e-5)
    np.testing.assert_allclose(r_re[k_real:].numpy(), total, rtol=1e-5)
    assert not s_im[k_real:].any() and not r_im[k_real:].any()
    t = tef.structure_tiling(kmax, posp.shape[0], 132)
    assert t["threads"] <= 320 and t["threads"] % 32 == 0
    assert t["stot"] >= 41 * t["nyg"] and t["ranges"] * t["atoms_per"] >= t["n_tab"] >= 24
    inv = tef._dense_to_list_t(kmax, t["stot"], "cpu").numpy()
    assert inv.shape == (t["dense"],)
    assert np.array_equal(np.sort(inv[inv >= 0]), np.arange(k_real))
    assert int((inv == -2).sum()) == 1
    with pytest.raises(ValueError, match="nz groups"):
        tef.structure_tiling((2, 2, 200), 64, 132)
