"""The wiring of the SWM4-NDP water: hands the tables of
``benchmark/layouts/swm4_ndp.py`` to the port's public API,
``SystemBuilder`` for the System (particles, isotropic Drudes,
constraints, averaged virtual sites, exclusions, LJ types),
``VVIntegrator`` for the TGNH thermostat and ``Context`` for the step, on
the traffic's ``recip`` route.  It imports the port only inside its
functions."""
from __future__ import annotations


def build_system(t):
    """The port's System of the tables ``t``."""
    from openmm_velocityverlet_tpu_torch import SystemBuilder
    b = SystemBuilder()
    for m, q, ty in zip(t["masses"].tolist(), t["charges"].tolist(),
                        t["lj_type"].tolist()):
        b.add_particle(m, charge=q, lj_type=ty)
    for (d, p), q, alpha in zip(t["drudes"].tolist(), t["drude_charge"],
                                t["drude_alpha"]):
        b.add_drude(d, p, -1, -1, -1, float(q), float(alpha), 1.0, 1.0)
    for (i, j), dist in zip(t["constraints"].tolist(), t["constraint_nm"]):
        b.add_constraint(i, j, float(dist))
    # each site is an average of its parents: the local frame is unused
    for site, parents, w in zip(t["vsites"].tolist(),
                                t["vsite_parents"].tolist(),
                                t["vsite_weights"].tolist()):
        b.add_vsite(site, parents, w, (-1.0, 1.0, 0.0), (-1.0, 0.0, 1.0),
                    (0.0, 0.0, 0.0))
    for i, j in t["exclusions"].tolist():
        b.add_exclusion(i, j)
    b.set_lj_from_type_params(t["lj_sigma"].tolist(),
                              t["lj_epsilon"].tolist())
    return b.finalize(t["box"], r_cutoff=t["cutoff"], use_pme=True,
                      ewald_tolerance=t["ewald_tolerance"])


def build_integrator(t):
    from openmm_velocityverlet_tpu_torch import VVIntegrator
    c = t["integrator"]
    integ = VVIntegrator(c["temperature"], c["frequency"],
                         c["drude_temperature"], c["drude_frequency"],
                         c["dt_ps"], c["num_nh_chains"], c["loops_per_step"])
    integ.setConstraintTolerance(c["constraint_tolerance"])
    integ.setMaxDrudeDistance(c["max_drude_distance_nm"])
    return integ


def build_context(t, traffic, device):
    """(Context, System) of the cell, positions and velocities set."""
    from openmm_velocityverlet_tpu_torch import Context
    system = build_system(t)
    ctx = Context(system, build_integrator(t), positions=t["positions"],
                  box=t["box"], recip=traffic.get("recip", "exact"),
                  device=device)
    ctx.set_velocities(t["velocities"])
    return ctx, system
