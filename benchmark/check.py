"""The comparison that decides ``correct``.

Everything compared is read through the port's public API, outside the
step: ``ctx.state`` (positions with their carried rounding, velocities,
box, the thermostat's chains) before and after each of ``CHECK_STEPS``
single steps (``ctx.step(1)``), and at each state a step starts from the
forces of ``ctx.evaluator.energy_forces(pos, box, want_energy=False)``,
the force-only form that the step's kick takes; at the start (the state
the benchmark handed the port) and after the window.  How the step is
implemented does not matter to the check.  (``ctx.get_forces()`` is the
energy query's form, whose float32 correction of an excluded pair at a
Drude's short distance is far coarser, and is not what the step runs.)

* ``force_gap.start`` / ``.end``: the widest gap between the port's and
  the reference's force on an atom, less the force of the atom's pairs
  within float32 rounding of the cutoff (a float32 distance may put such a
  pair on either side), over the root mean square of the reference's atom
  forces.
* ``step_gap.pos`` / ``.vel``: the reference's float64 step (for the
  water, the middle scheme: kick, RATTLE, TGNH, drift, SHAKE, hard wall)
  from each recorded state, with its own forces, against the port's next
  state: the widest gap of an atom's displacement over the root mean
  square displacement, and of an atom's new velocity over the root mean
  square velocity.  The force's share of one step is too small for these
  to see a force error the size of the control's; the force gaps see
  that.
* A configuration's reference (``benchmark/references/<name>.py``, its
  ``build(t, traffic, device, control=False)``) supplies the forces, the
  step and the numbers of its own, read on the port's window-end state
  (its ``numbers``), and any limit its configuration states itself (its
  ``stated_limits``).  Every other number is held to the limit of the same
  name in ``benchmark/limits/<cell>.json``; a number with no limit is not
  correct.
"""
from __future__ import annotations

import math

import torch

CHECK_STEPS = 2


def snapshot(ctx):
    """A copy of the port's public State, float64."""
    st = ctx.state
    return dict(pos=st.pos.double().clone(), pos_err=st.pos_err.double(),
                vel=st.vel.double().clone(), box=st.box.double().clone(),
                eta_dot=st.nh_eta_dot.double(),
                eta_dotdot=st.nh_eta_dotdot.double())


def record_steps(ctx, n=CHECK_STEPS):
    """``n`` single steps of the port, each state before them with the
    port's forces at it, and the state after the last."""
    states, forces = [], []
    for _ in range(n):
        states.append(snapshot(ctx))
        st = ctx.state
        _, f = ctx.evaluator.energy_forces(st.pos, st.box, want_energy=False)
        forces.append(f.double())
        ctx.step(1)
    states.append(snapshot(ctx))
    return dict(states=states, forces=forces)


def worst_atom(ref, f_port, f_ref, band):
    """(``force_gap``, the atom it is read on): see the module doc.
    Massless atoms (the M sites) are left out: their forces are on their
    parents."""
    d = f_port.double() - f_ref.double()
    gap = torch.clamp(torch.sqrt(torch.sum(d * d, 1)) - band.double(), min=0)
    gap = torch.where(ref.massive, gap, 0.0)
    f_rms = torch.sqrt(torch.mean(torch.sum(
        f_ref.double()[ref.massive] ** 2, 1)))
    return float(gap.max() / f_rms), int(gap.argmax())


def relative_gap(ref, got, want):
    """The widest gap of a massive atom's row over the rows' root mean
    square."""
    d = torch.sqrt(torch.sum((got - want) ** 2, 1))[ref.massive]
    rms = torch.sqrt(torch.mean(torch.sum(want[ref.massive] ** 2, 1)))
    return float(d.max() / rms)


def step_gaps(ref, before, after, f_ref):
    pos, vel = ref.step(before, f_ref)
    x0 = before["pos"] + before["pos_err"]
    x1 = after["pos"] + after["pos_err"]
    return (relative_gap(ref, x1 - x0, pos - x0),
            relative_gap(ref, after["vel"], vel))


def numbers(reference, t, traffic, start, end, limits, device,
            control=False):
    """Every compared number as (name, value, limit), and with ``control``
    the control's readings of the force gaps as {name: value}.
    ``reference`` is the configuration's reference module."""
    ref = reference.build(t, traffic, device)
    ctl_ref = (reference.build(t, traffic, device, control=True)
               if control else None)
    values, ctl = {}, {}
    pos_gaps, vel_gaps = [], []
    for name, rec in (("force_gap.start", start), ("force_gap.end", end)):
        gaps, ctl_gaps = [], []
        for k, f_port in enumerate(rec["forces"]):
            s = rec["states"][k]
            f_ref, _ = ref.forces(s["pos"], s["box"])
            gaps.append(worst_atom(ref, f_port, f_ref, ref.band)[0])
            if ctl_ref is not None:
                f_ctl, _ = ctl_ref.forces(s["pos"].float(), s["box"])
                ctl_gaps.append(worst_atom(ref, f_ctl, f_ref, ref.band)[0])
            gp, gv = step_gaps(ref, s, rec["states"][k + 1], f_ref)
            pos_gaps.append(gp)
            vel_gaps.append(gv)
        values[name] = max(gaps)
        if ctl_gaps:
            ctl[name] = max(ctl_gaps)
    values["step_gap.pos"] = max(pos_gaps)
    values["step_gap.vel"] = max(vel_gaps)
    values.update(ref.numbers(end["states"][0]))
    limits = dict(limits, **ref.stated_limits())
    rows = [(name, value, limits.get(name)) for name, value in values.items()]
    return rows, ctl


def is_correct(rows):
    return all(value is not None and math.isfinite(value)
               and limit is not None and value <= limit
               for _, value, limit in rows)
