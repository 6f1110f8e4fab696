#!/usr/bin/env python3
"""Bulk ionic-liquid workload on the PyTorch/CUDA port (the twin of
``examples/run-bulk.py``, with its flags, defaults, wiring and reporter
intervals): NPT/NVT bulk CLPol simulation with Langevin or (TG)NH
thermostat, optional cosine acceleration for viscosity, checkpoint
restart, and the full reporter set.

    python -m openmm_velocityverlet_tpu_torch.examples.run_bulk \\
        --gro conf.gro --psf topol.psf --prm ff.prm

It runs on the CUDA card and raises without one.  The reciprocal is the
port's default route, the exact-k sum by matmul (``recip="exact"``); the
JAX twin's Context defaults to ``"auto"``.  ``--mesh N`` splits the pair
sweep over N ranks, one device each, started by torchrun:

    torchrun --nproc-per-node N -m \
        openmm_velocityverlet_tpu_torch.examples.run_bulk --mesh N ...

(``parallel.mesh.launched_mesh``; another number of ranks raises).  Unlike
the twin, ``gen_simulation`` takes the Drude friction as a parameter
instead of reading the parsed arguments, and forwards ``ctx_kwargs`` to
``Context``.
"""
import argparse
import sys

from openmm_velocityverlet_tpu_torch import (BarostatConfig, Context,
                                             VVIntegrator)
from openmm_velocityverlet_tpu_torch.app import (CheckpointReporter,
                                                 DCDReporter,
                                                 DrudeTemperatureReporter,
                                                 GroReporter, Simulation,
                                                 StateDataReporter,
                                                 ViscosityReporter,
                                                 load_checkpoint)
from openmm_velocityverlet_tpu_torch.models.grofile import GroFile
from openmm_velocityverlet_tpu_torch.models.helper import add_clpol_coul_tt
from openmm_velocityverlet_tpu_torch.models.prmfile import \
    CharmmParameterSet
from openmm_velocityverlet_tpu_torch.models.psffile import OplsPsfFile
from openmm_velocityverlet_tpu_torch.parallel.mesh import launched_mesh

parser = argparse.ArgumentParser(
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("-n", "--nstep", type=int, default=int(1e6))
parser.add_argument("-t", "--temp", type=float, default=333)
parser.add_argument("-p", "--press", type=float, default=1)
parser.add_argument("--dt", type=float, default=0.001)
parser.add_argument("--thermostat", type=str, default="langevin",
                    choices=["langevin", "nose-hoover"])
parser.add_argument("--barostat", type=str, default="iso",
                    choices=["no", "iso", "semi-iso", "xyz", "xy", "z"])
parser.add_argument("--cos", type=float, default=0)
parser.add_argument("--gro", type=str, default="conf.gro")
parser.add_argument("--psf", type=str, default="topol.psf")
parser.add_argument("--prm", type=str, default="ff.prm")
parser.add_argument("--cpt", type=str)
parser.add_argument("--min", action="store_true")
parser.add_argument("--drude-friction", type=float, default=20.0,
                    help="Drude Langevin friction (1/ps); the reference "
                    "default is 20. 100 suppresses the kinetic T_Drude "
                    "discretization elevation at dt >= 1 fs")
parser.add_argument("--mesh", type=int, default=0,
                    help="split the pair sweep over N ranks, one device "
                    "each: launch with torchrun --nproc-per-node N")


def gen_simulation(gro_file, psf_file, prm_file, dt=0.001, T=300, P=1,
                   tcoupl="langevin", pcoupl="iso", cos=0, restart=None,
                   mesh_devices=0, drude_friction=20.0, **ctx_kwargs):
    """ctx_kwargs forward to Context (e.g. ``device="cpu"``)."""
    print("Building system...")
    gro = GroFile(gro_file)
    psf = OplsPsfFile(psf_file,
                      periodicBoxVectors=gro.getPeriodicBoxVectors())
    prm = CharmmParameterSet(prm_file)
    built = psf.createSystem(prm, nonbondedCutoff=1.2, constraints="HBonds",
                             rigidWater=True, verbose=True)
    is_drude = built.system.is_drude

    # TT damping between HO donors and Drude dipoles (run-bulk.py:39-44)
    donors = [a.idx for a in psf.atom_list if a.attype == "HO"]
    if is_drude and donors:
        print("Add TT damping between HO and Drude dipoles")
        add_clpol_coul_tt(built, donors)
        built.refinalize()

    print("Initializing simulation...")
    integrator = VVIntegrator(T, 10, 1, 40, dt)
    integrator.setUseMiddleScheme(True)
    integrator.setMaxDrudeDistance(0.02)
    if tcoupl == "langevin":
        # the reference's (Drude)LangevinIntegrator, as the partitioned
        # Langevin path of the VV integrator on every particle
        if is_drude:
            integrator.setFriction(5.0)
            integrator.setDrudeFriction(drude_friction)
            print(f"Drude Langevin thermostat: 5.0 /ps, "
                  f"{drude_friction} /ps")
            if dt > 0.00075 and drude_friction < 50.0:
                # the kinetic temperature of the stiff Drude springs
                # carries a discretization elevation at omega*dt ~ 1 that
                # shrinks with the Drude friction (tests/test_langevin_mts.py)
                print("WARNING: at dt >= 1 fs the kinetic T_Drude reads "
                      "~7 K at 20/ps from stiff-spring discretization; "
                      "pass --drude-friction 100 to suppress it "
                      "(configurational sampling is unaffected)")
        else:
            print("Langevin thermostat: 1.0 /ps")
            integrator.setFriction(1.0)
        for i in range(built.system.n_atoms):
            integrator.addParticleLangevin(i)
    elif tcoupl == "nose-hoover":
        if is_drude:
            print("Drude temperature-grouped Nose-Hoover thermostat: "
                  "10 /ps, 40 /ps")
        else:
            print("Nose-Hoover thermostat: 10 /ps")
    else:
        raise Exception("Available thermostat: langevin, nose-hoover")

    barostat = None
    if pcoupl != "no":
        barostat = BarostatConfig(kind=pcoupl, pressure=P, temperature=T)
    if cos != 0:
        integrator.setCosAcceleration(cos)

    mesh = None
    if mesh_devices:
        mesh = launched_mesh(mesh_devices, ctx_kwargs.get("device"))
        print(f"Sharding over {mesh.size} ranks ({mesh.backend}, "
              f"{mesh.device})")
    ctx = Context(built.system, integrator, positions=gro.positions,
                  box=gro.box, barostat=barostat, mesh=mesh, **ctx_kwargs)
    sim = Simulation(built.topology, ctx)
    if restart:
        load_checkpoint(ctx, restart)
        append = True
    else:
        ctx.set_velocities_to_temperature(T)
        append = False

    sim.reporters.append(CheckpointReporter("cpt.cpt", 10000))
    sim.reporters.append(GroReporter("dump.gro", 1000, logarithm=True,
                                     append=append))
    sim.reporters.append(DCDReporter("dump.dcd", 10000, append=append))
    sim.reporters.append(StateDataReporter(sys.stdout, 1000, box=False,
                                           volume=True, append=append))
    if is_drude:
        sim.reporters.append(DrudeTemperatureReporter("T_drude.txt", 10000,
                                                      append=append))
    if cos != 0:
        sim.reporters.append(ViscosityReporter("viscosity.txt", 1000,
                                               append=append))
    return sim


def simulation_from_args(args, **ctx_kwargs):
    """``gen_simulation`` wired from parsed command-line arguments."""
    return gen_simulation(gro_file=args.gro, psf_file=args.psf,
                          prm_file=args.prm, dt=args.dt, T=args.temp,
                          P=args.press, tcoupl=args.thermostat,
                          pcoupl=args.barostat, cos=args.cos,
                          restart=args.cpt, mesh_devices=args.mesh,
                          drude_friction=args.drude_friction, **ctx_kwargs)


def main(argv=None):
    args = parser.parse_args(argv)
    sim = simulation_from_args(args)
    print("Running...")
    for g, e in sim.context.group_energies().items():
        print(f"E_{g}: {e:.4f} kJ/mol")
    if args.min:
        print("Minimized energy:", sim.minimize_energy(100))
    sim.step(args.nstep)


if __name__ == "__main__":
    main()
