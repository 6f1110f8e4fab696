"""The wiring of the CL&Pol ionic liquid: hands the tables of
``benchmark/layouts/clpol_im21.py`` to the port's public API as
``oplspsffile.py``'s ``createSystem`` and run-bulk.py's TGNH branch build a
cell.  ``SystemBuilder`` takes the particles, the isotropic Drudes, the
constraints of the bonds to hydrogen, the bonds and angles, each OPLS
torsion as its periodic terms (V1 / 2 at n = 1, V2 / 2 at n = 2 and phase
pi, V3 / 2 at n = 3, V4 / 2 at n = 4 and phase pi), each improper as
k (1 - cos 2 phi) with k = V2 / 2, the Thole pairs (the pair's a over
(alpha_i alpha_j)^(1/6)), the exclusions, the 1-4 exceptions and the
Lennard-Jones types with an NBFIX entry for every pair of types (R_min of
the geometric sigma, epsilon scaled by the pair's k_ij).  ``VVIntegrator``
is the water's (TGNH, the middle scheme, the Drude wall).  On a card the
Context replays each step from a CUDA graph (``cuda_graph=True``): an
eager step of this liquid's six term kinds is several hundred launches from
the host, which then sets the step's pace.  It imports the port only inside
its functions."""
from __future__ import annotations

import math

import numpy as np

from benchmark.wirings import swm4_ndp


def exceptions(t):
    """(i, j, qq (e^2), sigma (nm), epsilon (kJ/mol)) of each 1-4
    exception, as oplspsffile.py builds them: between the two atoms the
    scaled Coulomb and Lennard-Jones, between an atom and the other's
    Drude or between the two Drudes the scaled Coulomb alone; and a zero
    exception between each core and its Drude."""
    q, ty = t["charges"], t["lj_type"]
    sig, eps = t["lj_sigma"], t["lj_epsilon"]
    drude_of = {int(p): int(d) for d, p in t["drudes"].tolist()}
    sc, sl = t["scale14_coulomb"], t["scale14_lj"]
    out = [(p, d, 0.0, 0.1, 0.0) for d, p in t["drudes"].tolist()]
    for a, b in t["pairs14"].tolist():
        out.append((a, b, sc * q[a] * q[b],
                    math.sqrt(sig[ty[a]] * sig[ty[b]]),
                    sl * math.sqrt(eps[ty[a]] * eps[ty[b]])))
        for x in [a] + ([drude_of[a]] if a in drude_of else []):
            for y in [b] + ([drude_of[b]] if b in drude_of else []):
                if (x, y) != (a, b):
                    out.append((x, y, sc * q[x] * q[y], 0.1, 0.0))
    return out


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
    for (i, j), r0, k in zip(t["bonds"].tolist(), t["bond_r0"],
                             t["bond_k"]):
        b.add_bond(i, j, float(r0), float(k))
    for (i, j, k), th0, kth in zip(t["angles"].tolist(), t["angle_theta0"],
                                   t["angle_k"]):
        b.add_angle(i, j, k, float(th0), float(kth))
    for (i, j, k, l), v in zip(t["torsions"].tolist(),
                               t["torsion_v"].tolist()):
        for n, vn in enumerate(v, start=1):
            if vn:
                b.add_dihedral(i, j, k, l, n, 0.0 if n % 2 else math.pi,
                               0.5 * vn)
    for (i, j, k, l), v2 in zip(t["impropers"].tolist(), t["improper_v2"]):
        b.add_improper(i, j, k, l, 0.5 * float(v2))
    drude_of = {int(p): (int(d), float(q), float(a)) for (d, p), q, a in
                zip(t["drudes"].tolist(), t["drude_charge"],
                    t["drude_alpha"])}
    for p1, p2 in t["thole_pairs"].tolist():
        (d1, q1, a1), (d2, q2, a2) = drude_of[p1], drude_of[p2]
        b.add_thole_pair(d1, p1, d2, p2, q1, q2, t["thole_a"], a1, a2)
    for i, j in t["exclusions"].tolist():
        b.add_exclusion(i, j)
    for i, j, qq, sigma, eps in exceptions(t):
        b.add_exception(i, j, qq, sigma, eps)
    sig, eps = t["lj_sigma"], t["lj_epsilon"]
    n = sig.size
    b.set_lj_from_type_params(sig.tolist(), eps.tolist(), nbfix={
        (i, j): (2.0 ** (1.0 / 6.0) * math.sqrt(sig[i] * sig[j]),
                 float(t["lj_k"][i, j] * np.sqrt(eps[i] * eps[j])))
        for i in range(n) for j in range(n)})
    return b.finalize(t["box"], r_cutoff=t["cutoff"], use_pme=True,
                      ewald_tolerance=t["ewald_tolerance"])


def build_context(t, traffic, device):
    """(Context, System) of the cell, positions and velocities set."""
    import torch
    from openmm_velocityverlet_tpu_torch import Context
    system = build_system(t)
    ctx = Context(system, swm4_ndp.build_integrator(t),
                  positions=t["positions"], box=t["box"],
                  recip=traffic.get("recip", "exact"),
                  cuda_graph=torch.device(device).type == "cuda",
                  device=device)
    ctx.set_velocities(t["velocities"])
    return ctx, system
