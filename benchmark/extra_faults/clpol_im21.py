"""Faults of the CL&Pol ionic liquid, each breaking the port's timed path
the way a later change might, undone when its ``with`` block closes.  Each
replaces one kind of ``ops/term_forces.py``'s term table, which both of
the port's term paths (``term_forces`` and ``mol_terms``) evaluate:

* ``thole_unscreened``: Thole's screening left out, so each 1-2 and 1-3
  pair of induced dipoles interacts as bare charges;
* ``torsions_dropped``: the dihedral kind (the torsions, and the
  impropers merged into it) gives no energy and no force;
* ``exc14_unscaled``: the 1-4 exceptions at full strength, Coulomb and
  Lennard-Jones unscaled by their 0.5.

Read on the card by ``benchmark/readings.py --fault <name>`` and on the CPU
by the benchmark's tests."""
from __future__ import annotations

import contextlib

NAMES = ("thole_unscreened", "torsions_dropped", "exc14_unscaled")
# the screening length's factor that makes Thole's screening 1 to float32
UNSCREENED = 1e4


@contextlib.contextmanager
def planted(name):
    import torch
    from openmm_velocityverlet_tpu_torch.ops import term_forces
    if name not in NAMES:
        raise ValueError(f"no fault {name!r}; the faults are {NAMES}")
    kind = {"thole_unscreened": "thole", "torsions_dropped": "dihedral",
            "exc14_unscaled": "exception"}[name]
    inner, width = term_forces._TERM_FNS[kind]
    if name == "thole_unscreened":
        def fn(delta, prm, _unused=None):
            # no host-made tensor: the step may be captured as a CUDA graph
            return inner(delta, torch.stack(
                [prm[:, 0], prm[:, 1] * UNSCREENED], 1))
    elif name == "torsions_dropped":
        def fn(delta, prm, _unused=None):
            e, grads = inner(delta, prm)
            return (torch.zeros_like(e),
                    [tuple(torch.zeros_like(g) for g in slot)
                     for slot in grads])
    else:
        def fn(delta, prm, _unused=None):
            return inner(delta, 2.0 * prm)
    term_forces._TERM_FNS[kind] = (fn, width)
    try:
        yield
    finally:
        term_forces._TERM_FNS[kind] = (inner, width)
