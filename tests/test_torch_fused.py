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
