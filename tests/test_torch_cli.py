"""The port's workload scripts (openmm_velocityverlet_tpu_torch/examples/
run_bulk.py and run_edl.py) against the JAX package's examples/run-bulk.py
and run-edl.py on files the tests write: chip_smoke's Drude fixture with
NBTHOLE and CMAP for the bulk script, and a small constant-voltage cell
with MoS2, ionic-liquid and IMG residues for the EDL script.  Each script's
group energies after gen_simulation equal its twin's, as printed; ten steps
end with finite terms; ``--help`` works; the CLI runs on the card or
raises."""
import argparse
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmm_velocityverlet_tpu_torch.examples import run_bulk, run_edl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# group energies: the port's plist sweep against the JAX dense sweep, both
# float32 (chip_smoke's pair-sweep energy rtol, E_RTOL) with an atol for
# the groups that are sums of small terms
E_RTOL, E_ATOL = 2e-5, 1e-3


def _jax_script(name):
    """The JAX package's example script as a module (its file name has a
    dash); its module-level ``args`` is what ``__main__`` would parse."""
    spec = importlib.util.spec_from_file_location(
        name.replace("-", "_") + "_jax", os.path.join(ROOT, "examples",
                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.args = argparse.Namespace(drude_friction=20.0)
    return mod


def _exact_context(mod):
    """The JAX Context of a script module on the port's reciprocal route
    (recip="exact"), with the CMAP tables as device arrays: the JAX Context
    cannot trace its CMAP term on the host numpy tables (ROADMAP C)."""
    real = mod.Context

    def context(system, integ, **kw):
        system = system.replace(**{k: jnp.asarray(getattr(system, k))
                                   for k in ("cmap_map", "cmap_coeffs",
                                             "cmap_res")})
        return real(system, integ, recip="exact", **kw)
    return context


def _assert_groups_equal(mine, ref):
    assert set(mine) == set(ref)
    for g in ref:
        np.testing.assert_allclose(mine[g], ref[g], rtol=E_RTOL, atol=E_ATOL,
                                   err_msg=f"group {g}")
        # and as the script prints them, to the last printed digit or two
        assert abs(float(f"{mine[g]:.4f}") - float(f"{ref[g]:.4f}")) \
            <= E_ATOL + E_RTOL * abs(ref[g])


def _finite_after(sim, n=10):
    sim.step(n)
    terms = sim.context.potential_energy_terms()
    assert sim.current_step == n
    assert all(np.isfinite(v) for v in terms.values()), terms
    assert np.isfinite(sim.context.get_positions()).all()
    sim.flush()
    return terms


def _write_edl_fixture(directory, lz=8.0, side=2.6):
    """A small constant-voltage cell in run-edl's layout, as PSF/PRM/GRO:
    two 3 x 3 MoS2 electrode layers at z 0.15 and lz/2 - 0.15 (MoS2
    residues, neutral), six Drude ion pairs between them (chip_smoke's
    IMA / IMB ions) and one massless IMG particle per liquid atom, the
    i-th mirroring the i-th liquid atom across z = lz/2.  Returns the
    paths (psf, prm, gro)."""
    atoms, pos = [], []
    rid = 0
    for z in (0.15, lz / 2 - 0.15):
        for ix in range(3):
            for iy in range(3):
                rid += 1
                name, typ = (("MO", "MOS") if (ix + iy) % 2 else
                             ("S", "SMO"))
                atoms.append((name, typ, 0.0, 95.9 if typ == "MOS" else 32.1,
                              0.0, 0.0, "MoS2", rid))
                pos.append(((ix + 0.5) * side / 3, (iy + 0.5) * side / 3, z))
    rng = np.random.default_rng(4)
    liquid = []
    for m in range(6):
        c = np.array([0.45 + 0.85 * (m % 3), 0.65 + 1.3 * (m // 3),
                      1.0 + 0.4 * m]) + rng.normal(0, 0.01, 3)
        for res, unit in (("IMA", (("N1", "TA", 1.8, 14.007, -1.0, 0.9,
                                    (0.0, 0.0, 0.0)),
                                   ("DP1", "DP_", -0.8, 0.4, 0.0, 0.0,
                                    (0.02, 0.0, 0.0)))),
                          ("IMB", (("C1", "TB", 0.2, 12.011, -1.5, 0.9,
                                    (0.0, 0.35, 0.1)),
                                   ("DP2", "DP_", -1.2, 0.4, 0.0, 0.0,
                                    (0.0, 0.37, 0.1))))):
            rid += 1
            for name, typ, q, mass, alpha, thole, off in unit:
                liquid.append(len(atoms))
                atoms.append((name, typ, q, mass, alpha, thole, res, rid))
                pos.append(tuple(c + np.array(off)))
    for i in list(liquid):
        rid += 1
        atoms.append(("I", "IMG", 0.0, 0.0, 0.0, 0.0, "IMG", rid))
        x, y, z = pos[i]
        pos.append((x, y, lz - z))
    bonds = [(i + 1, i + 2) for i in liquid if atoms[i][0] in ("N1", "C1")]
    lines = ["PSF DRUDE", "", "       1 !NTITLE",
             " REMARKS constant-voltage fixture", "",
             f"{len(atoms):8d} !NATOM"]
    for k, (name, typ, q, m, alpha, thole, res, r) in enumerate(atoms):
        lines.append(f"{k + 1:8d} S    {r:<6d}{res:<6s}{name:<6s}"
                     f"{typ:<6s}{q:10.6f}{m:12.4f}  0 {alpha:9.4f}"
                     f"{thole:9.4f}")
    lines += ["", f"{len(bonds):8d} !NBOND: bonds"]
    flat = [x for b in bonds for x in b]
    lines += ["".join(f"{x:8d}" for x in flat[j:j + 8])
              for j in range(0, len(flat), 8)]
    for tag in ("NTHETA: angles", "NPHI: dihedrals", "NIMPHI: impropers"):
        lines += ["", f"       0 !{tag}"]
    psf = os.path.join(directory, "edl.psf")
    with open(psf, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    prm_lines = ["* constant-voltage fixture", "*", "", "ATOMS"]
    for k, (t, m) in enumerate((("TA", 14.007), ("TB", 12.011),
                                ("DP_", 0.0), ("MOS", 95.94), ("SMO", 32.06),
                                ("IMG", 0.0))):
        prm_lines.append(f"MASS {k + 1:5d} {t:6s} {m:9.4f}")
    prm_lines += ["", "BONDS", "TA DP_ 500.0 0.0", "TB DP_ 500.0 0.0", "",
                  "NONBONDED", "TA 0.0 -0.10 1.6", "TB 0.0 -0.12 1.7",
                  "DP_ 0.0 -0.00 0.0", "MOS 0.0 -0.05 2.2",
                  "SMO 0.0 -0.30 2.0", "IMG 0.0 -0.00 0.0", "", "END"]
    prm = os.path.join(directory, "edl.prm")
    with open(prm, "w") as fh:
        fh.write("\n".join(prm_lines) + "\n")
    gro_lines = ["constant-voltage fixture", f"{len(atoms)}"]
    for k, (a, p) in enumerate(zip(atoms, pos)):
        gro_lines.append(f"{a[7] % 100000:5d}{a[6]:<5s}{a[0]:>5s}"
                         f"{(k + 1) % 100000:5d}{p[0]:8.3f}{p[1]:8.3f}"
                         f"{p[2]:8.3f}")
    gro_lines.append(f"{side:10.5f}{side:10.5f}{lz:10.5f}")
    gro = os.path.join(directory, "edl.gro")
    with open(gro, "w") as fh:
        fh.write("\n".join(gro_lines) + "\n")
    return psf, prm, gro


@pytest.mark.parametrize("script", ["run_bulk", "run_edl"])
def test_help(script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", f"openmm_velocityverlet_tpu_torch.examples."
         f"{script}", "--help"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--gro" in out.stdout and "--cpt" in out.stdout
    assert "--mesh" in out.stdout


def test_run_bulk_matches_jax_script(tmp_path, monkeypatch):
    """run_bulk.gen_simulation on chip_smoke's fixture (8 cells, 72 atoms;
    Drudes, NBTHOLE, CMAP) with the CLI's defaults (Langevin on every
    particle, iso barostat, 333 K) against examples/run-bulk.py's on the
    same files: the same group energies, as the script prints them; then
    10 steps with finite terms."""
    monkeypatch.chdir(tmp_path)
    psf, prm, gro = chip_smoke.write_charmm_fixture(str(tmp_path), 2)
    args = run_bulk.parser.parse_args(["--gro", gro, "--psf", psf,
                                       "--prm", prm])
    sim = run_bulk.simulation_from_args(args, device="cpu")
    jmod = _jax_script("run-bulk")
    monkeypatch.setattr(jmod, "Context", _exact_context(jmod))
    jsim = jmod.gen_simulation(gro_file=gro, psf_file=psf, prm_file=prm,
                               dt=args.dt, T=args.temp, P=args.press,
                               tcoupl=args.thermostat, pcoupl=args.barostat)
    ctx = sim.context
    assert ctx.barostat.kind == "iso" and ctx.data.temperature == 333.0
    assert ctx.data.ld_pairs.shape[0] == 16 and ctx.evaluator.recip_method \
        == "exact"
    _assert_groups_equal(sim.context.group_energies(),
                         jsim.context.group_energies())
    terms = _finite_after(sim)
    assert terms["cmap"] != 0.0 and terms["nbthole"] != 0.0
    assert (tmp_path / "dump.gro").exists()


def test_run_bulk_options_and_mesh(tmp_path, monkeypatch):
    """The Nose-Hoover / no-barostat / cosine wiring against the JAX
    script's, a restart from a checkpoint the script's own reporter wrote,
    and --mesh N > 0 in a launch of another number of ranks, which raises
    naming torchrun (the mesh itself: tests/test_torch_mesh.py)."""
    monkeypatch.chdir(tmp_path)
    psf, prm, gro = chip_smoke.write_charmm_fixture(str(tmp_path), 2)
    args = run_bulk.parser.parse_args([
        "--gro", gro, "--psf", psf, "--prm", prm, "--thermostat",
        "nose-hoover", "--barostat", "no", "--cos", "0.02"])
    sim = run_bulk.simulation_from_args(args, device="cpu")
    assert sim.context.barostat is None
    assert sim.context.data.ld_pairs.shape[0] == 0
    assert sim.context.data.cos_acceleration == 0.02
    jmod = _jax_script("run-bulk")
    monkeypatch.setattr(jmod, "Context", _exact_context(jmod))
    jsim = jmod.gen_simulation(gro_file=gro, psf_file=psf, prm_file=prm,
                               T=333, tcoupl="nose-hoover", pcoupl="no",
                               cos=0.02)
    _assert_groups_equal(sim.context.group_energies(),
                         jsim.context.group_energies())
    assert [type(r).__name__ for r in sim.reporters] == \
        [type(r).__name__ for r in jsim.reporters]
    sim.context.step(4)
    sim.save_checkpoint("cpt.cpt_4")
    again = run_bulk.simulation_from_args(run_bulk.parser.parse_args([
        "--gro", gro, "--psf", psf, "--prm", prm, "--thermostat",
        "nose-hoover", "--barostat", "no", "--cpt", "cpt.cpt_4"]),
        device="cpu")
    assert again.current_step == 4
    np.testing.assert_array_equal(again.context.get_positions(),
                                  sim.context.get_positions())
    with pytest.raises(ValueError, match="torchrun"):
        run_bulk.simulation_from_args(run_bulk.parser.parse_args(
            ["--gro", gro, "--psf", psf, "--prm", prm, "--mesh", "2"]),
            device="cpu")


def test_cli_runs_on_the_card_or_raises(tmp_path, monkeypatch):
    """No fallback hides the device: the CLI has no --device flag, and
    without a card each script's main() raises at the Context; with one it
    runs."""
    monkeypatch.chdir(tmp_path)
    files = {run_bulk: chip_smoke.write_charmm_fixture(str(tmp_path), 2),
             run_edl: _write_edl_fixture(str(tmp_path))}
    for script, (psf, prm, gro) in files.items():
        argv = ["--gro", gro, "--psf", psf, "--prm", prm, "-n", "2"]
        if torch.cuda.is_available():
            script.main(argv)
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                script.main(argv)


def test_run_edl_matches_jax_script(tmp_path, monkeypatch):
    """run_edl.gen_simulation at -v 1 on a written 66-atom cell (MoS2,
    Drude ion pairs, IMG images) against examples/run-edl.py's on the same
    files, both on recip="exact": the same groups (with the restraint and
    the Drude wall as group 0), as printed; the mirror route taken; 10 steps
    with finite terms and the images on their parents' mirror."""
    monkeypatch.chdir(tmp_path)
    psf, prm, gro = _write_edl_fixture(str(tmp_path))
    args = run_edl.parser.parse_args(["--gro", gro, "--psf", psf,
                                      "--prm", prm, "-v", "1"])
    sim = run_edl.gen_simulation(gro_file=gro, psf_file=psf, prm_file=prm,
                                 dt=args.dt, T=args.temp,
                                 voltage=args.voltage, device="cpu")
    jmod = _jax_script("run-edl")
    jsim = jmod.gen_simulation(gro_file=gro, psf_file=psf, prm_file=prm,
                               dt=args.dt, T=args.temp, voltage=args.voltage,
                               recip="exact")
    ctx = sim.context
    assert ctx.image_mirror == (42, 18, 24, 4.0)
    assert ctx.data.electrolyte.shape[0] == 24
    assert ctx.data.ld_normal.shape[0] == 18
    _assert_groups_equal(ctx.group_energies(), jsim.context.group_energies())
    assert 0 in ctx.group_energies()
    _finite_after(sim)
    p = ctx.get_positions()
    np.testing.assert_allclose(p[42:, :2], p[18:42, :2], atol=1e-6)
    np.testing.assert_allclose(p[42:, 2], 8.0 - p[18:42, 2], atol=1e-5)
