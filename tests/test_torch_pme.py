"""The port's FFT PME (ops/pme.py) against the JAX package's, on the same
numpy inputs: the grid and spline tables, the energy and its autograd
forces against JAX's plus jax.grad, the binned spreading and its overflow
fallback, PME against the port's exact sum at tests/test_pme.py's
tolerances, a Context on recip="pme" against the JAX Context, and the
"auto" choice."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_velocityverlet_tpu as jpkg
import openmm_velocityverlet_tpu_torch as tpkg
from openmm_velocityverlet_tpu.ops import ewald as jew
from openmm_velocityverlet_tpu.ops import pme as jpme
from openmm_velocityverlet_tpu_torch.ops import ewald as tew
from openmm_velocityverlet_tpu_torch.ops import pme as tpme
from openmm_velocityverlet_tpu_torch.system import system_from_numpy
from tests.test_pme import _random_system

# the boxes of tests/test_pme.py (at both its spacings), its 125-atom
# lattice, the 19,500-atom drude_water box and the EDL cell of chip_smoke
BOXES = [((3.0, 3.2, 6.0), 0.10), ((3.0, 3.2, 6.0), 0.08),
         ((2.0, 2.0, 2.0), 0.10), ((9.35, 9.35, 9.35), 0.10),
         ((5.44, 8.84, 40.8), 0.10)]


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def _both(seed, spacing, n=300):
    pos, box, q = _random_system(n=n, seed=seed)
    beta, kmax = jew.ewald_parameters(1.2, box=np.asarray(box))
    grid = jpme.choose_grid(np.asarray(box), spacing)
    return pos, box, q, beta, kmax, grid


def _port_value_and_grad(fn, pos):
    p = _t(pos).requires_grad_(True)
    e = fn(p)
    (g,) = torch.autograd.grad(e, p)
    return float(e.detach()), g.numpy()


@pytest.mark.parametrize("box,spacing", BOXES)
def test_grid_and_tables_match_jax(box, spacing):
    """choose_grid gives JAX's grid ((96, 96, 96) for the 9.35 nm box);
    the B-spline weights and the Euler factors are JAX's."""
    grid = tpme.choose_grid(np.asarray(box), spacing)
    assert grid == jpme.choose_grid(np.asarray(box), spacing)
    if box[0] == 9.35:
        assert grid == (96, 96, 96)
    for k in grid:
        np.testing.assert_array_equal(tpme._euler_factors(k),
                                      jpme._euler_factors(k))
    t = np.random.default_rng(1).uniform(0, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(tpme._bspline4(_t(t)).numpy(),
                               np.asarray(jpme._bspline4(jnp.asarray(t))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed,spacing", [(0, 0.10), (5, 0.08)])
def test_pme_energy_and_forces_match_jax(seed, spacing):
    """reciprocal_energy_pme and its autograd forces against JAX's and
    jax.grad on test_pme._random_system (300 atoms): energy rtol 1e-5,
    forces atol 1e-4 max|F|."""
    pos, box, q, beta, _, grid = _both(seed, spacing)
    e_j, g_j = jax.value_and_grad(
        lambda p: jpme.reciprocal_energy_pme(p, box, q, beta, grid))(pos)
    e_t, g_t = _port_value_and_grad(
        lambda p: tpme.reciprocal_energy_pme(p, _t(box), _t(q), beta, grid),
        pos)
    np.testing.assert_allclose(e_t, float(e_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t, g_j, atol=1e-4 * np.abs(g_j).max())


def test_binned_spreading_matches_scatter_and_jax():
    """The z-binned spreading equals the scatter path (rtol 1e-5,
    tests/test_pme.py:40-56) and JAX's binned path; with a capacity of 2
    the overflow selects the scatter grid on the device (rtol 1e-6); the
    bin table holds every atom once."""
    pos, box, q, beta, _, grid = _both(3, 0.10)
    pt, bt, qt = _t(pos), _t(box), _t(q)
    bins, overflow = tpme._plane_binned_tables(pt[:, 2], bt[2], grid[2], 48)
    assert not bool(overflow)
    b = bins.numpy()
    np.testing.assert_array_equal(np.sort(b[b >= 0]), np.arange(300))
    e_s = float(tpme.reciprocal_energy_pme(pt, bt, qt, beta, grid))
    e_b = float(tpme.reciprocal_energy_pme(pt, bt, qt, beta, grid,
                                           bin_cap=48))
    np.testing.assert_allclose(e_b, e_s, rtol=1e-5)
    e_bj = float(jpme.reciprocal_energy_pme(pos, box, q, beta, grid,
                                            bin_cap=48))
    np.testing.assert_allclose(e_b, e_bj, rtol=1e-5)
    _, over = tpme._plane_binned_tables(pt[:, 2], bt[2], grid[2], 2)
    assert bool(over)
    e_o = float(tpme.reciprocal_energy_pme(pt, bt, qt, beta, grid,
                                           bin_cap=2))
    np.testing.assert_allclose(e_o, e_s, rtol=1e-6)
    # the binned path's autograd forces are the scatter path's
    _, g_s = _port_value_and_grad(
        lambda p: tpme.reciprocal_energy_pme(p, bt, qt, beta, grid), pos)
    _, g_b = _port_value_and_grad(
        lambda p: tpme.reciprocal_energy_pme(p, bt, qt, beta, grid,
                                             bin_cap=48), pos)
    np.testing.assert_allclose(g_b, g_s, atol=1e-4 * np.abs(g_s).max())


def test_pme_matches_port_exact_sum():
    """The port's PME against the port's exact sum: energy within 1e-4
    (tests/test_pme.py:37), forces within 1.5e-3 max|F| at spacing 0.08
    (:69)."""
    pos, box, q, beta, kmax, grid = _both(0, 0.10)
    bt, qt = _t(box), _t(q)
    e_pme = float(tpme.reciprocal_energy_pme(_t(pos), bt, qt, beta, grid))
    e_ex = float(tew.reciprocal_energy(_t(pos), bt, qt, beta, kmax))
    assert abs(e_pme - e_ex) <= 1e-4 * abs(e_ex)
    pos, box, q, beta, kmax, grid = _both(5, 0.08)
    bt, qt = _t(box), _t(q)
    _, g_pm = _port_value_and_grad(
        lambda p: tpme.reciprocal_energy_pme(p, bt, qt, beta, grid), pos)
    _, g_ex = _port_value_and_grad(
        lambda p: tew.reciprocal_energy(p, bt, qt, beta, kmax), pos)
    np.testing.assert_allclose(g_pm, g_ex, atol=1.5e-3 * np.abs(g_ex).max())


def _lattice(pkg):
    """tests/test_pme.py:100-133's 125-atom charged LJ lattice."""
    rng = np.random.default_rng(11)
    b = pkg.SystemBuilder()
    n_side = 5
    for i in range(n_side ** 3):
        b.add_particle(39.948, charge=(0.2 if i % 2 == 0 else -0.2),
                       lj_type=0)
    b.set_lj_from_type_params([0.34], [0.996])
    box = np.array([n_side * 0.4] * 3)
    pos = np.stack(np.meshgrid(
        *[np.arange(n_side) * 0.4 + 0.2] * 3, indexing="ij"),
        -1).reshape(-1, 3)
    pos += rng.normal(0, 0.01, pos.shape)
    return b.finalize(box, r_cutoff=0.9, use_pme=True), pos, box


def test_context_pme_tracks_jax():
    """Context(recip="pme") on the 125-atom lattice against the JAX
    Context(recip="pme") (both on the dense pair sweep): the terms, and a
    20-step trajectory at tests/test_torch_slice.py's tolerances (max
    |dpos| < 2e-5 nm a step, terms rtol 1e-3 / atol 0.5, kinetic rtol
    1e-3); PME's coul_recip against the exact route's within 1e-3 (|E| +
    1), as tests/test_pme.py:127-129."""
    js, pos, box = _lattice(jpkg)
    ps = system_from_numpy(js)
    rng = np.random.default_rng(4)
    vel = (rng.normal(0, 1, pos.shape) * np.sqrt(
        0.0083144626 * 120.0 * np.asarray(js.inv_masses))[:, None]
        ).astype(np.float32)
    runs = {}
    for pkg in (jpkg, tpkg):
        integ = pkg.VVIntegrator(temperature=120.0, step_size=0.002)
        kw = dict(device="cpu", pair_kernel="dense") if pkg is tpkg else {}
        ctx = pkg.Context(js if pkg is jpkg else ps, integ, positions=pos,
                          box=box, recip="pme", **kw)
        assert ctx.evaluator.recip_method == "pme"
        assert tuple(ctx.evaluator.pme_grid) == (20, 20, 20)
        ctx.set_velocities(vel)
        t0 = ctx.potential_energy_terms()
        traj = []
        for _ in range(20):
            ctx.step(1)
            traj.append(np.asarray(ctx.get_positions(), np.float64))
        runs[pkg] = (t0, np.stack(traj), ctx.potential_energy_terms(),
                     ctx.kinetic_energy())
    (j0, tj, ej, kj), (t0, tt, et, kt) = runs[jpkg], runs[tpkg]
    drift = np.abs(tt - tj).max(axis=(1, 2))
    assert drift.max() < 2e-5, drift
    for start, ref in ((t0, j0), (et, ej)):
        assert set(start) == set(ref)
        for k in ref:
            np.testing.assert_allclose(start[k], ref[k], rtol=1e-3,
                                       atol=0.5, err_msg=k)
    np.testing.assert_allclose(kt, kj, rtol=1e-3)
    ex = tpkg.Context(ps, tpkg.VVIntegrator(temperature=120.0,
                                            step_size=0.002),
                      positions=pos, box=box, recip="exact", device="cpu",
                      pair_kernel="dense").potential_energy_terms()
    assert abs(t0["coul_recip"] - ex["coul_recip"]) <= 1e-3 * (
        abs(ex["coul_recip"]) + 1.0)


@pytest.mark.parametrize("n_atoms,kmax,box", [
    (20000, (6, 6, 27), (3.4, 3.4, 15.0)),
    (19500, (20, 20, 20), (9.35, 9.35, 9.35)),
    (40296, (11, 19, 97), (5.44, 8.84, 40.8)),
    (500000, (40, 40, 40), (40.0, 40.0, 40.0))])
def test_auto_chooses_exact_or_pme_on_jax_grid(n_atoms, kmax, box):
    """choose_reciprocal returns "exact" or "pme" with JAX's grid, from the
    port's own cost model (costs fitted on the card)."""
    method, grid = tpme.choose_reciprocal(n_atoms, kmax, np.asarray(box))
    assert method in ("exact", "pme")
    assert grid == jpme.choose_reciprocal(n_atoms, kmax, np.asarray(box))[1]
    assert (method == "pme") == (tpme.pme_cost(n_atoms, grid)
                                 < tpme.exact_sum_cost(n_atoms, kmax))


def test_auto_route_constructs_and_steps():
    """ForceEvaluator(recip="auto") resolves to the cost model's choice;
    without a box hint or Ewald it stays on "exact"; a Context on "auto"
    steps."""
    js, pos, box = _lattice(jpkg)
    ps = system_from_numpy(js)
    ev = tpkg.ForceEvaluator(ps, recip="auto", box_hint=box, pos_hint=pos,
                             device="cpu")
    want, grid = tpme.choose_reciprocal(ps.n_atoms, ps.kmax, box)
    assert ev.recip_method == want
    assert ev.pme_grid == (grid if want == "pme" else None)
    assert tpkg.ForceEvaluator(ps, recip="auto",
                               device="cpu").recip_method == "exact"
    ctx = tpkg.Context(ps, tpkg.VVIntegrator(temperature=120.0,
                                             step_size=0.002),
                       positions=pos, box=box, recip="auto", device="cpu")
    ctx.step(2)
    assert np.isfinite(ctx.get_positions()).all()
    with pytest.raises(ValueError, match="box_hint"):
        tpkg.ForceEvaluator(ps, recip="pme", device="cpu")


def test_pme_under_the_barostat_keeps_its_grid():
    """Under the Monte Carlo barostat the box scales while the PME grid
    chosen at construction stays, as in the JAX package: after accepted
    moves the context's coul_recip is reciprocal_energy_pme on the new box
    with the original grid."""
    js, pos, box = _lattice(jpkg)
    ctx = tpkg.Context(system_from_numpy(js), tpkg.VVIntegrator(
        temperature=120.0, step_size=0.002), positions=pos, box=box,
        recip="pme", device="cpu",
        barostat=tpkg.BarostatConfig("iso", 1.0, 120.0, frequency=1))
    grid = ctx.evaluator.pme_grid
    ctx.set_velocities_to_temperature(120.0)
    ctx.step(12)
    assert ctx.baro_accepts > 0 and ctx.evaluator.pme_grid == grid
    new_box = ctx.get_box()
    assert not np.array_equal(new_box, box.astype(np.float32))
    st = ctx.state
    e = float(tpme.reciprocal_energy_pme(
        ctx.evaluator.place_vsites(st.pos), st.box, ctx.evaluator.t.charges,
        js.ewald_beta, grid))
    np.testing.assert_allclose(ctx.potential_energy_terms()["coul_recip"],
                               e, rtol=1e-6)
