"""Faults planted under the harness, to show that the comparison which
decides ``correct`` catches them: each breaks the port's timed path the
way a later change might, and is undone when its ``with`` block closes.

    with faults.planted("shake_off", cfg):
        run.run_cell(...)

The six of ``NAMES`` hold for every configuration.  A configuration may
name further faults in a module of its own, ``benchmark/extra_faults/
<cfg["faults"]>.py``, with its ``NAMES`` and a ``planted(name)`` context
manager.  Read on the card by ``benchmark/readings.py --fault <name>``
(the upper readings of the step's and the trajectory's numbers) and on
the CPU by the benchmark's tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib

NAMES = ("state_unchanged", "half_forces_left_out", "one_force_altered",
         "shake_off", "thermostat_off", "dt_doubled")
# the alteration of ``one_force_altered``, kJ/mol/nm
ALTERED = 50.0


def _patch(obj, name, value, undo):
    undo.append((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def _force_fault(change, undo):
    from openmm_velocityverlet_tpu_torch.forces import ForceEvaluator
    inner = ForceEvaluator.energy_forces

    def energy_forces(self, pos, box, *args, **kwargs):
        out = inner(self, pos, box, *args, **kwargs)
        f = out[1].clone()
        change(f)
        return (out[0], f) + tuple(out[2:])
    _patch(ForceEvaluator, "energy_forces", energy_forces, undo)


def extra(cfg):
    """The configuration's own faults module, or None."""
    name = (cfg or {}).get("faults")
    return (importlib.import_module("benchmark.extra_faults." + name)
            if name else None)


def names(cfg=None):
    """The faults a run of the configuration ``cfg`` can have planted."""
    mod = extra(cfg)
    return NAMES + (tuple(mod.NAMES) if mod is not None else ())


@contextlib.contextmanager
def planted(name, cfg=None):
    if name not in NAMES:
        if name not in names(cfg):
            raise ValueError(f"no fault {name!r}; the faults are "
                             f"{names(cfg)}")
        with extra(cfg).planted(name):
            yield
        return
    import torch
    from openmm_velocityverlet_tpu_torch.context import Context
    from openmm_velocityverlet_tpu_torch.ops import constraints
    undo = []
    if name == "state_unchanged":
        _patch(Context, "_step_middle",
               lambda self, cache: torch.zeros((), dtype=torch.bool), undo)
    elif name == "half_forces_left_out":
        def change(f):
            f[f.shape[0] // 2:] = 0.0
        _force_fault(change, undo)
    elif name == "one_force_altered":
        def change(f):
            f[0, 0] += ALTERED
        _force_fault(change, undo)
    elif name == "shake_off":
        _patch(constraints, "apply_position_constraints",
               lambda pos_ref, pos_new, *args, **kwargs: pos_new, undo)
    elif name == "thermostat_off":
        _patch(Context, "_thermostat",
               lambda self, pos, vel, box, st: (vel, st), undo)
    elif name == "dt_doubled":
        inner = Context.__init__

        def init(self, *args, **kwargs):
            inner(self, *args, **kwargs)
            self.data = dataclasses.replace(self.data, dt=2.0 * self.data.dt)
            self._dt_inv_m = 2.0 * self._dt_inv_m
        _patch(Context, "__init__", init, undo)
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
