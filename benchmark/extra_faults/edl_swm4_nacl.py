"""Faults of the constant-voltage slab, each breaking the port's timed path
the way a later change might, undone when its ``with`` block closes:

* ``images_unsynced``: the image sync skipped, so the images stay where
  the start put them;
* ``field_off``: the applied field left out of the step;
* ``vsite_image_stale``: the sync mirrors the parents' stored rows, so an
  M site's image sits on the mirror of the M site's stale stored row (a
  massless site's row never moves; only its placement does).

Read on the card by ``benchmark/readings.py --fault <name>`` and on the CPU
by the benchmark's tests."""
from __future__ import annotations

import contextlib

NAMES = ("images_unsynced", "field_off", "vsite_image_stale")


@contextlib.contextmanager
def planted(name):
    from openmm_velocityverlet_tpu_torch.context import Context
    from openmm_velocityverlet_tpu_torch.integrators import stepping
    if name not in NAMES:
        raise ValueError(f"no fault {name!r}; the faults are {NAMES}")
    undo = []
    if name == "images_unsynced":
        undo.append(("_sync_images", Context._sync_images))
        Context._sync_images = lambda self, new_pos, new_err: (new_pos,
                                                               new_err)
    elif name == "field_off":
        inner = Context.__init__

        def init(self, *args, **kwargs):
            inner(self, *args, **kwargs)
            self._efield = None
        undo.append(("__init__", inner))
        Context.__init__ = init
    else:
        def sync(self, new_pos, new_err):
            img = stepping.update_image_positions(
                new_pos, self._images, self.data.mirror_location)
            return img, new_err
        undo.append(("_sync_images", Context._sync_images))
        Context._sync_images = sync
    try:
        yield
    finally:
        for attr, value in reversed(undo):
            setattr(Context, attr, value)
