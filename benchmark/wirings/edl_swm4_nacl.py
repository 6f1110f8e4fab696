"""The wiring of the constant-voltage slab: hands the tables of
``benchmark/layouts/edl_swm4_nacl.py`` to the port's public API as
``openmm_velocityverlet_tpu_torch/examples/run_edl.py`` wires a cell, with
the electrodes held fixed (massless) in place of its Langevin electrode
and restraint.  ``SystemBuilder`` takes the particles, the isotropic
Drudes, the water's constraints, the virtual sites, the liquid's
exclusions and the Lennard-Jones types combined by the Lorentz-Berthelot
rule; ``models/helper.py`` gives the images their negated charges and
their parents' exclusions, sets run-edl's Lennard-Jones groups and joins
each image to its parent's molecule; ``VVIntegrator`` takes the TGNH
thermostat, the mirror plane with every image pair and the field
``voltage_v`` x 2 / Lz on every liquid site; the Drude wall is
``external.wall_lj126``.  It imports the port only inside its
functions."""
from __future__ import annotations

import types

import numpy as np

from benchmark.wirings import swm4_ndp


def build_system(t):
    """The port's System of the tables ``t``."""
    from openmm_velocityverlet_tpu_torch import SystemBuilder
    from openmm_velocityverlet_tpu_torch.models import helper
    b = SystemBuilder()
    for m, q, ty in zip(t["masses"].tolist(), t["charges"].tolist(),
                        t["lj_type"].tolist()):
        b.add_particle(m, charge=q, lj_type=ty)
    for (d, p), q, alpha in zip(t["drudes"].tolist(), t["drude_charge"],
                                t["drude_alpha"]):
        b.add_drude(d, p, -1, -1, -1, float(q), float(alpha), 1.0, 1.0)
    for (i, j), dist in zip(t["constraints"].tolist(), t["constraint_nm"]):
        b.add_constraint(i, j, float(dist))
    for site, parents, w in zip(t["vsites"].tolist(),
                                t["vsite_parents"].tolist(),
                                t["vsite_weights"].tolist()):
        b.add_vsite(site, parents, w, (-1.0, 1.0, 0.0), (-1.0, 0.0, 1.0),
                    (0.0, 0.0, 0.0))
    # the liquid's own exclusions; mirror_image_exclusions adds the images'
    first_image = int(t["image_pairs"][0, 1])
    for i, j in t["exclusions"].tolist():
        if i < first_image and j < first_image:
            b.add_exclusion(i, j)
    sig, eps = t["lj_sigma"], t["lj_epsilon"]
    rmin = 2.0 ** (1.0 / 6.0) * 0.5 * (sig[:, None] + sig[None, :])
    b.set_lj_from_type_params(
        sig.tolist(), eps.tolist(),
        nbfix={(i, j): (float(rmin[i, j]), float(np.sqrt(eps[i] * eps[j])))
               for i in range(sig.size) for j in range(sig.size)})
    built = types.SimpleNamespace(builder=b)
    pairs = t["image_pairs"].tolist()
    helper.assign_image_charges(built, pairs)
    helper.mirror_image_exclusions(built, pairs)
    helper.set_lj_interaction_groups(built, t["lj_group"],
                                     t["lj_group_pairs"].tolist())
    helper.add_molecule_links(built, pairs)
    return b.finalize(t["box"], r_cutoff=t["cutoff"], use_pme=True,
                      ewald_tolerance=t["ewald_tolerance"])


def build_integrator(t, voltage_v):
    integ = swm4_ndp.build_integrator(t)
    integ.setMirrorLocation(t["mirror_nm"])
    for parent, image in t["image_pairs"].tolist():
        integ.addImagePair(image, parent)
    integ.setElectricField(voltage_v * 2.0 / t["box"][2])
    for i in t["liquid"].tolist():
        integ.addParticleElectrolyte(i)
    return integ


def build_context(t, traffic, device):
    """(Context, System) of the cell, positions and velocities set."""
    from openmm_velocityverlet_tpu_torch import Context
    from openmm_velocityverlet_tpu_torch.ops import external
    w = t["wall"]
    wall = external.wall_lj126(w["particles"], w["axis"], w["bound"],
                               epsilon=w["epsilon"], sigma=w["sigma"])
    system = build_system(t)
    ctx = Context(system, build_integrator(t, float(traffic["voltage_v"])),
                  external_forces=[wall], positions=t["positions"],
                  box=t["box"], recip=traffic.get("recip", "exact"),
                  device=device)
    ctx.set_velocities(t["velocities"])
    return ctx, system
