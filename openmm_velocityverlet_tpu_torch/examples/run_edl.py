#!/usr/bin/env python3
"""Constant-voltage electrical-double-layer workload on the PyTorch/CUDA
port (the twin of ``examples/run-edl.py``, with its flags, defaults, wiring
and reporter intervals): MoS2 electrodes with image charges, Langevin on
the solid and TGNH on the liquid, a Drude wall, electrode restraints and
an applied voltage.

    python -m openmm_velocityverlet_tpu_torch.examples.run_edl -v 1 \\
        --gro conf.gro --psf topol.psf --prm ff.prm

The residues named ``MoS2`` are the electrodes, those named ``IMG`` the
image particles (the i-th image mirrors the i-th liquid atom), and every
other residue the liquid.  It runs on the CUDA card and raises without one.
The reciprocal is the port's default route, the exact-k sum by matmul
(``recip="exact"``; over the liquid only when the images are the trailing
block mirroring the block before them, ``Context``'s mirror route); the
JAX twin's Context defaults to ``"auto"``.  ``--mesh N`` splits the pair
sweep over N ranks started by ``torchrun --nproc-per-node N`` (another
number of ranks raises); on a mesh the reciprocal takes the explicit
evaluation over all atoms, as in the JAX package.
"""
import argparse
import random
import sys

import numpy as np

from openmm_velocityverlet_tpu_torch import Context, VVIntegrator
from openmm_velocityverlet_tpu_torch.app import (CheckpointReporter,
                                                 DCDReporter,
                                                 DrudeTemperatureReporter,
                                                 GroReporter, Simulation,
                                                 StateDataReporter,
                                                 load_checkpoint)
from openmm_velocityverlet_tpu_torch.models.grofile import GroFile
from openmm_velocityverlet_tpu_torch.models.helper import (
    add_clpol_coul_tt, add_molecule_links, assign_image_charges,
    mirror_image_exclusions, set_lj_interaction_groups)
from openmm_velocityverlet_tpu_torch.models.prmfile import \
    CharmmParameterSet
from openmm_velocityverlet_tpu_torch.models.psffile import OplsPsfFile
from openmm_velocityverlet_tpu_torch.ops import external
from openmm_velocityverlet_tpu_torch.parallel.mesh import launched_mesh

parser = argparse.ArgumentParser(
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("-n", "--nstep", type=int, default=int(1e6))
parser.add_argument("-t", "--temp", type=float, default=333)
parser.add_argument("-v", "--voltage", type=float, default=0.0)
parser.add_argument("--dt", type=float, default=0.001)
parser.add_argument("--gro", type=str, default="conf.gro")
parser.add_argument("--psf", type=str, default="topol.psf")
parser.add_argument("--prm", type=str, default="ff.prm")
parser.add_argument("--cpt", type=str)
parser.add_argument("--mesh", type=int, default=0,
                    help="split the pair sweep over N ranks, one device "
                    "each: launch with torchrun --nproc-per-node N")


def gen_simulation(gro_file, psf_file, prm_file, dt=0.001, T=333, voltage=0,
                   restart=None, **ctx_kwargs):
    """ctx_kwargs forward to Context (e.g. ``device="cpu"``, the perf knobs
    ``sort_refresh`` and ``pair_ts``, ``mesh``)."""
    print("Building system...")
    gro = GroFile(gro_file)
    lz = float(gro.box[2])
    psf = OplsPsfFile(psf_file,
                      periodicBoxVectors=gro.getPeriodicBoxVectors())
    prm = CharmmParameterSet(prm_file)
    built = psf.createSystem(prm, nonbondedCutoff=1.2, constraints="HBonds",
                             rigidWater=True, verbose=True)
    top = built.topology
    is_drude = built.system.is_drude

    # group assignment by residue (run-edl.py:36-49)
    group_mos = top.select_by_residue_name("MoS2")
    group_mos_core = [i for i in group_mos
                      if not top.atom_names[i].startswith("D")]
    group_img = top.select_by_residue_name("IMG")
    group_ils = top.select_by_residue_name("MoS2", "IMG", invert=True)
    group_ils_drude = [i for i in group_ils
                       if top.atom_names[i].startswith("D")]
    image_pairs = list(zip(group_ils, group_img))
    for name, g in (("mos", group_mos), ("ils", group_ils),
                    ("img", group_img), ("mos_core", group_mos_core)):
        print("    Number of atoms in group %10s: %i" % (name, len(g)))

    donors = [a.idx for a in psf.atom_list if a.attype == "HO"]
    if is_drude and donors:
        print("Add TT damping between HO and Drude dipoles")
        add_clpol_coul_tt(built, donors)

    # image charges: q_img = -q_parent (run-edl.py:54-58), with the
    # parents' exclusion structure mirrored onto the images
    assign_image_charges(built, image_pairs)
    mirror_image_exclusions(built, image_pairs)

    # LJ interaction groups (run-edl.py:60-62): img<->img and img<->mos LJ
    # removed; labels 0 = ils, 1 = img, 2 = mos
    groups = np.zeros(built.system.n_atoms, np.int32)
    groups[group_img] = 1
    groups[group_mos] = 2
    set_lj_interaction_groups(built, groups, [(0, 0), (0, 2), (2, 2), (1, 0)])

    # restrain MoS2 cores (run-edl.py:65-67)
    print("Add restraint for MoS2...")
    kcal_a2 = 4.184 / 0.01  # kcal/mol/A^2 -> kJ/mol/nm^2
    restraint = external.spring_self(
        group_mos_core, gro.positions,
        [0.01 * kcal_a2, 0.01 * kcal_a2, 5.0 * kcal_a2])

    # Drude z-wall (run-edl.py:69-73)
    print("Add wall for Drude particles of ILs...")
    wall = external.wall_lj126(group_ils_drude, 2, (0.0, lz / 2),
                               epsilon=0.5 * 4.184, sigma=0.15)

    # randomize positions to break overlaps (run-edl.py:75-78)
    random.seed(0)
    positions = np.array(gro.positions)
    for i in range(len(positions)):
        positions[i] += (np.array([random.random(), random.random(),
                                   random.random()]) / 1000.0)

    integrator = VVIntegrator(T, 10, 1, 40, dt)
    integrator.setUseMiddleScheme(True)
    integrator.setMaxDrudeDistance(0.02)
    for i in group_mos:
        integrator.addParticleLangevin(i)
    integrator.setMirrorLocation(lz / 2)
    for parent, image in image_pairs:
        integrator.addImagePair(image, parent)
    add_molecule_links(built, image_pairs)
    if voltage != 0:
        integrator.setElectricField(voltage / lz * 2)
        for i in group_ils:
            integrator.addParticleElectrolyte(i)

    built.refinalize()
    print("Initializing simulation...")
    ctx = Context(built.system, integrator, positions=positions, box=gro.box,
                  external_forces=[restraint, wall], **ctx_kwargs)
    sim = Simulation(top, ctx)
    if restart:
        load_checkpoint(ctx, restart)
        append = True
    else:
        ctx.set_velocities_to_temperature(T)
        append = False

    sim.reporters.append(DCDReporter("dump.dcd", 10000, append=append))
    sim.reporters.append(CheckpointReporter("cpt.cpt", 10000))
    sim.reporters.append(GroReporter("dump.gro", 1000, logarithm=True,
                                     subset=group_mos + group_ils,
                                     append=append))
    sim.reporters.append(StateDataReporter(sys.stdout, 10000, box=False,
                                           append=append))
    sim.reporters.append(DrudeTemperatureReporter("T_drude.txt", 100000,
                                                  append=append))
    return sim


def main(argv=None):
    args = parser.parse_args(argv)
    ctx_kwargs = {}
    if args.mesh:
        ctx_kwargs["mesh"] = launched_mesh(args.mesh)
        print(f"Sharding over {args.mesh} ranks")
    sim = gen_simulation(gro_file=args.gro, psf_file=args.psf,
                         prm_file=args.prm, dt=args.dt, T=args.temp,
                         voltage=args.voltage, restart=args.cpt,
                         **ctx_kwargs)
    print("Running...")
    for g, e in sim.context.group_energies().items():
        print(f"E_{g}: {e:.4f} kJ/mol")
    sim.step(args.nstep)


if __name__ == "__main__":
    main()
