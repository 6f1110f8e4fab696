"""ommhelper-parity helpers (counterpart of
``openmm_velocityverlet_tpu/models/helper.py``; reference:
examples/ommhelper/force.py + util.py glue that mutates the OpenMM system
after createSystem).

Each function takes any object whose ``.builder`` is this package's
``SystemBuilder`` (for instance ``types.SimpleNamespace(builder=b)``),
changes the builder in place and returns the object; ``finalize`` the
builder afterwards."""
from __future__ import annotations

import numpy as np


def add_clpol_coul_tt(built, donors, b=45.0, cutoff=1.2):
    """Tang-Toennies damping between H-bond donors and Drude dipoles
    (CLPolCoulTT, force.py:230-282).  The TT charge of a Drude parent is the
    *negated Drude charge*; all other particles use their own charge."""
    charges = np.array(built.builder.charges, np.float64)
    tt_charges = charges.copy()
    for (drude, parent, *_rest) in built.builder.drude:
        tt_charges[parent] = -charges[drude]
    built.builder.set_tt_damping(list(donors), tt_charges, b=b, cutoff=cutoff)
    return built


def assign_image_charges(built, image_pairs):
    """Constant-voltage image charges: image charge = -parent charge
    (run-edl.py:55-58 setParticleParameters).

    Image particles also become massless here: their positions are
    overwritten by the mirror sync every step (updateImagePositions,
    imageCharge.cu), so integrating them (as the reference does) only
    accumulates unbounded velocities that pollute KE reporting and the
    CM motion remover.  Massless particles are skipped by the integrator
    and all DOF bookkeeping, exactly like virtual sites."""
    for parent, image in image_pairs:
        built.builder.charges[image] = -built.builder.charges[parent]
        built.builder.masses[image] = 0.0
    return built


def set_lj_interaction_groups(built, groups, allowed_pairs):
    """CustomNonbondedForce interaction groups (run-edl.py:60-62).

    groups: list of particle-index lists; atoms not listed get group 0...
    Actually: pass ``groups`` as a (N,) int array of group labels and
    ``allowed_pairs`` as an iterable of (g1, g2) allowed combinations.
    """
    groups = np.asarray(groups, np.int32)
    g = int(groups.max()) + 1
    allowed = np.zeros((g, g), bool)
    for (a, b) in allowed_pairs:
        allowed[a, b] = True
        allowed[b, a] = True
    built.builder.lj_group = groups
    built.builder.lj_group_allowed = allowed
    return built


def add_molecule_links(built, pairs):
    """Fake bonds keeping image/parent in one 'molecule'
    (run-edl.py:93-95 addBond(image, parent, 0, 0))."""
    built.builder.extra_molecule_links.extend(
        (int(i), int(j)) for i, j in pairs)
    return built


def mirror_image_exclusions(built, image_pairs):
    """Give image particles their parents' exclusion/exception structure.

    Images mirror ALL liquid particles — including Drude particles sitting
    ~0.01 nm from their parents.  The liquid's intramolecular pairs are
    excluded through the bond graph, but the images carry no bonds, so
    without this the image of a Drude and the image of its parent interact
    by bare Coulomb at contact distance (~1e8 kJ/mol of spurious energy).
    The reference's (stripped) edl PSFs carry the image topology for the
    same reason.  1-4 exceptions are mirrored Coulomb-only: negating both
    charges preserves the q_i q_j product, while image LJ is removed by the
    interaction groups anyway."""
    img_of = {int(p): int(i) for (p, i) in image_pairs}
    b = built.builder
    for (i, j) in list(b.exclusions):
        if i in img_of and j in img_of:
            b.add_exclusion(img_of[i], img_of[j])
    for (i, j), (qq, sigma, eps) in list(b.exceptions.items()):
        if i in img_of and j in img_of:
            b.add_exception(img_of[i], img_of[j], qq, 0.1, 0.0)
    return built
