"""A polarizable-water box: the layout of ``__graft_entry__._drude_system``
in the JAX package, built with host numpy only.

Each molecule is a core O (15.2 Da, +1.2 e) with a Drude particle (0.4 Da,
-1.0 e, alpha 0.00097 nm^3), two hydrogens (-0.1 e) held by two
constraints, one H-O-H angle and full intramolecular exclusions.
Molecules sit on a cubic grid of 0.55 nm spacing.  At ``n_mol=4875`` the
box holds 19,500 atoms, the atom count of ``bench.py``'s headline system.
"""
from __future__ import annotations

import numpy as np

from .builder import SystemBuilder


def drude_water_box(n_mol: int, r_cutoff=None, builder_cls=SystemBuilder):
    """Returns (system, positions (N,3), box (3,)).

    ``r_cutoff`` defaults to the fixture's ``min(0.7, 0.45 L)``.
    ``builder_cls`` is any class with the ``SystemBuilder`` methods (the
    JAX package's builder too), so both packages can build the same
    system from the same code."""
    b = builder_cls()
    side = int(np.ceil(n_mol ** (1.0 / 3.0)))
    spacing = 0.55
    box = np.array([max(side * spacing, 1.6)] * 3)
    pos = []
    for m in range(n_mol):
        cx = (m % side + 0.5) * spacing
        cy = ((m // side) % side + 0.5) * spacing
        cz = (m // (side * side) + 0.5) * spacing
        o = b.add_particle(15.2, charge=1.2, lj_type=0)
        d = b.add_particle(0.4, charge=-1.0, lj_type=1)
        h1 = b.add_particle(1.008, charge=-0.1, lj_type=1)
        h2 = b.add_particle(1.008, charge=-0.1, lj_type=1)
        pos += [[cx, cy, cz], [cx, cy, cz],
                [cx + 0.0957, cy, cz], [cx, cy + 0.0957, cz]]
        b.add_drude(d, o, -1, -1, -1, -1.0, 0.00097, 1.0, 1.0)
        b.add_constraint(o, h1, 0.0957)
        b.add_constraint(o, h2, 0.0957)
        b.add_angle(h1, o, h2, 1.824, 300.0)
        for i in (o, d, h1, h2):
            for j in (o, d, h1, h2):
                if i < j:
                    b.add_exclusion(i, j)
    b.set_lj_from_type_params([0.3166, 0.1], [0.65, 0.0])
    if r_cutoff is None:
        r_cutoff = min(0.7, float(box[0]) / 2 * 0.9)
    system = b.finalize(box, r_cutoff=r_cutoff, use_pme=True)
    return system, np.asarray(pos), box
