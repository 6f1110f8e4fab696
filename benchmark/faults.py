"""Faults planted under the harness, to show that the comparison which
decides ``correct`` catches them: each breaks the port's timed path the
way a later change might, and is undone when its ``with`` block closes.

    with faults.planted("shake_off"):
        run.run_cell(...)

Read on the card by ``benchmark/readings.py --fault <name>`` (the upper
readings of the step's and the trajectory's numbers) and on the CPU by
the benchmark's tests.
"""
from __future__ import annotations

import contextlib
import dataclasses

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


@contextlib.contextmanager
def planted(name):
    import torch
    from benchmark import port
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
        inner = port.build_context

        def build_context(*args, **kwargs):
            ctx, system = inner(*args, **kwargs)
            ctx.data = dataclasses.replace(ctx.data, dt=2.0 * ctx.data.dt)
            ctx._dt_inv_m = 2.0 * ctx._dt_inv_m
            return ctx, system
        _patch(port, "build_context", build_context, undo)
    else:
        raise ValueError(f"no fault {name!r}; the faults are {NAMES}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
