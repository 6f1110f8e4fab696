"""Monte Carlo barostats: iso, anisotropic xyz / xy / z, and membrane
semi-iso (counterpart of ``openmm_velocityverlet_tpu/integrators/
barostat.py``).

One attempt scales the box and the molecules' centres of mass, evaluates
the energy difference and accepts with

    P_acc = exp(-(dE + P dV - N_mol kT ln(V'/V)) / kT),

adapting the move size every 10 attempts as OpenMM's
MonteCarloBarostatImpl does.  ``Context`` makes an attempt every
``frequency`` steps, at the point of the step where the reference calls
updateContextState (VVIntegrator.cpp:234).  The draws come from a
``torch.Generator`` (the ``State``'s); ``attempt_move`` also takes them as
tensors, so a caller can hand it another stream's numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..system import resolve_device
from ..units import BAR_TO_KJ_MOL_NM3, BOLTZ

KINDS = ("iso", "xyz", "xy", "z", "semi-iso")


@dataclasses.dataclass(frozen=True)
class BarostatConfig:
    kind: str                 # iso | xyz | xy | z | semi-iso
    pressure: float           # bar
    temperature: float        # K
    frequency: int = 100      # steps between attempts

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown barostat kind {self.kind}")


@dataclasses.dataclass
class BarostatState:
    """The move size (nm^3) and the attempt / acceptance counts since the
    last adaptation, as device scalars: reading them is not needed to
    step."""
    volume_scale: torch.Tensor    # () f32
    n_attempted: torch.Tensor     # () i32
    n_accepted: torch.Tensor      # () i32


def make_barostat_state(initial_volume, device="cuda") -> BarostatState:
    """A fresh move size (1% of ``initial_volume``) and counters on
    ``device``: the card unless given, as every entry point."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return BarostatState(
        volume_scale=torch.as_tensor(0.01 * float(initial_volume),
                                     dtype=torch.float32, device=device),
        n_attempted=torch.zeros((), **i32), n_accepted=torch.zeros((), **i32))


def draw(kind, generator, device):
    """One attempt's draws from ``generator``: {"axis": the axis index
    (xyz, xy), "pick_z": a bool (semi-iso), "u_dv": uniform [0,1) for the
    volume change, "u_acc": uniform for the acceptance test}."""
    out = {}
    if kind in ("xyz", "xy"):
        out["axis"] = torch.randint(0, 3 if kind == "xyz" else 2, (),
                                    generator=generator, device=device)
    elif kind == "semi-iso":
        out["pick_z"] = torch.rand((), generator=generator,
                                   device=device) < 0.5
    u = torch.rand((2,), generator=generator, device=device)
    out["u_dv"], out["u_acc"] = u[0], u[1]
    return out


def _axis_weights(kind, draws, device):
    """Which box axes the attempt scales (1.0 = scaled)."""
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "iso":
        return torch.ones(3, **f32)
    if kind in ("xyz", "xy"):
        ax = torch.as_tensor(draws["axis"], device=device)
        return (torch.arange(3, device=device) == ax).to(torch.float32)
    if kind == "z":
        return torch.tensor([0.0, 0.0, 1.0], **f32)
    if kind == "semi-iso":       # XY coupled or Z, alternating at random
        pick_z = torch.as_tensor(draws["pick_z"], device=device)
        return torch.where(pick_z, torch.tensor([0.0, 0.0, 1.0], **f32),
                           torch.tensor([1.0, 1.0, 0.0], **f32))
    raise ValueError(f"unknown barostat kind {kind}")


def molecule_tables(system, device):
    """The device tables of the centre-of-mass scaling: the dense member
    table (``mol_table``, massless members left out) as gather indices and
    mass weights, the molecules' inverse masses and each atom's molecule."""
    table = np.asarray(system.mol_table)
    idx = np.maximum(table, 0)
    w = np.asarray(system.masses, np.float32)[idx] * (table >= 0)
    return dict(
        idx=torch.as_tensor(idx.astype(np.int64), device=device),
        w=torch.as_tensor(w.astype(np.float32), device=device),
        inv_m=torch.as_tensor(np.asarray(system.mol_inv_masses, np.float32),
                              device=device),
        mol_id=torch.as_tensor(np.asarray(system.particle_mol_id, np.int64),
                               device=device),
        n_mol=int(np.asarray(system.mol_masses).shape[0]))


def attempt_move(cfg: BarostatConfig, bstate: BarostatState, pos, box,
                 mol, energy_fn, draws):
    """One MC volume attempt.  ``mol`` is ``molecule_tables(system)``,
    ``energy_fn(pos, box)`` the potential as a device scalar and ``draws``
    what ``draw`` returns.  Returns (accepted device bool, pos', box',
    bstate', axis_scale (3,)); nothing is read on the host."""
    dev = pos.device
    weights = _axis_weights(cfg.kind, draws, dev)
    u_dv = torch.as_tensor(draws["u_dv"], dtype=torch.float32, device=dev)
    u_acc = torch.as_tensor(draws["u_acc"], dtype=torch.float32, device=dev)

    vol = box[0] * box[1] * box[2]
    delta_v = bstate.volume_scale * (2.0 * u_dv - 1.0)
    new_vol = vol + delta_v
    ratio = new_vol / vol
    axis_scale = torch.where(weights > 0, ratio ** (1.0 / weights.sum()),
                             torch.ones_like(weights))

    # molecular centre-of-mass scaling: intramolecular geometry stays rigid
    com = torch.sum(mol["w"][..., None] * pos[mol["idx"]], dim=1) \
        * mol["inv_m"][:, None]
    shift = com * (axis_scale[None, :] - 1.0)
    new_pos = pos + shift[mol["mol_id"]]
    new_box = box * axis_scale

    e_old = energy_fn(pos, box)
    e_new = energy_fn(new_pos, new_box)
    kt = BOLTZ * cfg.temperature
    p_int = cfg.pressure * BAR_TO_KJ_MOL_NM3
    w = (e_new - e_old + p_int * delta_v
         - mol["n_mol"] * kt * torch.log(new_vol / vol))
    accept = (w <= 0) | (u_acc < torch.exp(-w / kt))

    pos = torch.where(accept, new_pos, pos)
    box = torch.where(accept, new_box, box)
    n_att = bstate.n_attempted + 1
    n_acc = bstate.n_accepted + accept.to(torch.int32)
    # OpenMM-style adaptation of the move size every 10 attempts
    frac = n_acc.to(torch.float32) / n_att.to(torch.float32)
    vs = bstate.volume_scale
    vs_new = torch.where(frac < 0.25, vs / 1.1, vs)
    vs_new = torch.where(frac > 0.75, torch.minimum(vs_new * 1.1, vol * 0.3),
                         vs_new)
    adapt = n_att >= 10
    zero = torch.zeros_like(n_att)
    bstate = BarostatState(
        volume_scale=torch.where(adapt, vs_new, vs),
        n_attempted=torch.where(adapt, zero, n_att),
        n_accepted=torch.where(adapt, zero, n_acc))
    return accept, pos, box, bstate, axis_scale
