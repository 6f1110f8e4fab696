"""System and State — the static/dynamic split of the engine (counterpart of
``openmm_velocityverlet_tpu/system.py``).

``System`` holds the static tables as host numpy arrays, exactly as the JAX
builder produces them; ``System.to(device)`` gives the tensor view the step
reads.  ``State`` holds what evolves, as torch tensors on the context's
device, with the compensated two-float position pair (``pos``/``pos_err``)
and the Nose-Hoover chain arrays.  Randomness is a ``torch.Generator``.

``system_from_numpy``/``state_from_numpy`` read any object with the same
field names through ``np.asarray`` (a GB block through
``GBData.from_numpy``), so a JAX ``System``/``State`` carries across
without this package importing jax.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .ops.gb import GBData
from .units import BOLTZ

# fields that are plain Python configuration, not tables
_STATIC_FIELDS = ("gb", "r_cutoff", "r_switch", "ewald_beta", "kmax",
                  "use_dispersion_correction", "has_cm_motion_remover")


@dataclasses.dataclass
class System:
    """Static description of the simulated system; see the JAX ``System``
    for the meaning of every table.  Index tables are padded with -1."""

    # ---- per-particle ----
    masses: np.ndarray
    inv_masses: np.ndarray
    charges: np.ndarray
    lj_type: np.ndarray
    acoef: np.ndarray
    bcoef: np.ndarray
    lj_group: np.ndarray
    lj_group_allowed: np.ndarray
    # ---- bonded terms ----
    bonds: np.ndarray
    bond_r0: np.ndarray
    bond_k: np.ndarray
    angles: np.ndarray
    angle_theta0: np.ndarray
    angle_k: np.ndarray
    ub_bonds: np.ndarray
    ub_r0: np.ndarray
    ub_k: np.ndarray
    dihedrals: np.ndarray
    dihedral_n: np.ndarray
    dihedral_phase: np.ndarray
    dihedral_k: np.ndarray
    impropers: np.ndarray
    improper_k: np.ndarray
    # ---- nonbonded bookkeeping ----
    exclusions: np.ndarray
    exc_idx: np.ndarray
    exc_qq: np.ndarray
    exc_c6: np.ndarray
    exc_c12: np.ndarray
    disp_coef_a2: np.ndarray
    disp_coef_b: np.ndarray
    # ---- constraints / virtual sites ----
    constraints: np.ndarray
    constraint_dist: np.ndarray
    vsite_index: np.ndarray
    vsite_parents: np.ndarray
    vsite_origin_w: np.ndarray
    vsite_x_w: np.ndarray
    vsite_y_w: np.ndarray
    vsite_local: np.ndarray
    # ---- Drude / Thole ----
    drude_pairs: np.ndarray
    drude_k3: np.ndarray
    drude_k1: np.ndarray
    drude_k2: np.ndarray
    drude_aniso: np.ndarray
    thole_sites: np.ndarray
    thole_qq: np.ndarray
    thole_screen: np.ndarray
    # ---- NBTHOLE ----
    nbt_idx: np.ndarray
    nbt_alpha: np.ndarray
    nbt_coef: np.ndarray
    # ---- CLPol Tang-Toennies damping ----
    tt_donors: np.ndarray
    tt_charges: np.ndarray
    tt_dipole_mask: np.ndarray
    tt_b: np.ndarray
    tt_cutoff: np.ndarray
    # ---- molecules ----
    particle_mol_id: np.ndarray
    mol_masses: np.ndarray
    mol_inv_masses: np.ndarray
    mol_table: np.ndarray
    # ---- CMAP ----
    cmap_atoms: np.ndarray
    cmap_map: np.ndarray
    cmap_coeffs: np.ndarray
    cmap_res: np.ndarray
    # ---- implicit solvent (ops/gb.GBData), or None ----
    gb: Optional[GBData] = None
    # ---- nonbonded method parameters ----
    r_cutoff: float = 1.2
    r_switch: float = 0.0
    ewald_beta: float = 0.0
    kmax: tuple = (0, 0, 0)
    use_dispersion_correction: bool = True
    has_cm_motion_remover: bool = True

    @property
    def n_atoms(self) -> int:
        return self.masses.shape[0]

    @property
    def n_molecules(self) -> int:
        return self.mol_masses.shape[0]

    @property
    def is_drude(self) -> bool:
        return self.drude_pairs.shape[0] > 0

    def replace(self, **changes) -> "System":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> SimpleNamespace:
        """Tensor view of every table on ``device``: floats as float32,
        integer tables as int64 (torch's index type), masks as bool."""
        out = {}
        for f in dataclasses.fields(self):
            if f.name in _STATIC_FIELDS:
                continue
            a = np.asarray(getattr(self, f.name))
            if a.dtype == np.bool_:
                t = torch.as_tensor(a, device=device)
            elif np.issubdtype(a.dtype, np.integer):
                t = torch.as_tensor(a.astype(np.int64), device=device)
            else:
                t = torch.as_tensor(a.astype(np.float32), device=device)
            out[f.name] = t
        return SimpleNamespace(**out)


def system_from_numpy(obj) -> System:
    """A port ``System`` from any object carrying the same field names
    (e.g. a JAX ``System``), read leaf by leaf through ``np.asarray``."""
    kw = {}
    for f in dataclasses.fields(System):
        v = getattr(obj, f.name)
        if f.name == "gb":
            kw[f.name] = None if v is None else GBData.from_numpy(v)
        elif f.name == "kmax":
            kw[f.name] = tuple(int(k) for k in v)
        elif f.name in _STATIC_FIELDS:
            kw[f.name] = type(f.default)(v)
        else:
            kw[f.name] = np.asarray(v)
    return System(**kw)


def pad_system(system: System, n_pad: int) -> System:
    """Append ``n_pad - n_atoms`` ghost particles (the JAX ``pad_system``):
    massless, chargeless, of a dedicated zero-LJ type, excluded from every
    term table, each its own massless molecule.  ``Context(mesh=...)`` pads
    to a multiple of the mesh size and hides the ghosts from the public
    position and velocity surface.  Refuses implicit-solvent (GB) systems,
    as the JAX package does."""
    n = system.n_atoms
    extra = int(n_pad) - n
    if extra <= 0:
        return system
    if system.gb is not None:
        raise NotImplementedError(
            "mesh padding of implicit-solvent (GB) systems is not supported"
            " — GB is a non-periodic model (oplspsffile.py:1585-1586)")
    d = {f.name: getattr(system, f.name) for f in dataclasses.fields(system)}

    def app(name, fill):
        a = np.asarray(d[name])
        d[name] = np.concatenate(
            [a, np.full((extra,) + a.shape[1:], fill, a.dtype)], axis=0)

    # the ghosts' LJ type is a new zero row and column
    t_dim = np.asarray(d["acoef"]).shape[0]
    for name in ("acoef", "bcoef"):
        d[name] = np.pad(np.asarray(d[name]), ((0, 1), (0, 1))).astype(
            np.float32)
    app("lj_type", t_dim)
    for name in ("masses", "inv_masses", "charges", "nbt_alpha",
                 "tt_charges"):
        app(name, 0.0)
    app("lj_group", 0)
    app("nbt_idx", 0)
    app("tt_dipole_mask", False)
    app("exclusions", -1)
    app("exc_idx", -1)
    for name in ("exc_qq", "exc_c6", "exc_c12"):
        app(name, 0.0)
    mol_id = np.asarray(d["particle_mol_id"])
    m = np.asarray(d["mol_masses"]).shape[0]
    d["particle_mol_id"] = np.concatenate(
        [mol_id, (m + np.arange(extra)).astype(mol_id.dtype)])
    for name in ("mol_masses", "mol_inv_masses", "mol_table"):
        # a molecule's row of the per-molecule tables: mass 0, no members
        a = np.asarray(d[name])
        d[name] = np.concatenate(
            [a, np.full((extra,) + a.shape[1:], -1 if a.ndim == 2 else 0,
                        a.dtype)], axis=0)
    return System(**d)


@dataclasses.dataclass
class State:
    """Everything that evolves during the simulation.

    ``pos`` is the float32 value and ``pos_err`` the accumulated rounding
    error of the compensated position update (the reference's
    posq + posqCorrection split, middle.cu:80-97).  The step counter and
    time are host numbers, so reading them never waits for the device; the
    cosine velocity amplitude is the device scalar of the last thermostat
    application when cosine acceleration is on."""

    pos: torch.Tensor            # (N,3) f32
    pos_err: torch.Tensor        # (N,3) f32
    vel: torch.Tensor            # (N,3) f32
    box: torch.Tensor            # (3,) f32
    nh_eta: torch.Tensor         # (G,C) f32
    nh_eta_dot: torch.Tensor     # (G,C+1) f32
    nh_eta_dotdot: torch.Tensor  # (G,C) f32
    generator: torch.Generator   # Langevin noise stream
    step: int = 0
    time: float = 0.0
    cos_v: float | torch.Tensor = 0.0

    @property
    def positions(self) -> torch.Tensor:
        """Full-precision positions (pos + accumulated correction)."""
        return self.pos + self.pos_err

    def replace(self, **changes) -> "State":
        return dataclasses.replace(self, **changes)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device.  The entry points default to "cuda":
    without a card that default raises here, at construction, rather than
    the engine running on the host; a CPU run is asked for with
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} (the entry points' default) needs a "
            "CUDA card and none is available; pass device='cpu' to run on "
            "the host")
    return dev


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def make_state(positions, box, velocities=None, n_temp_groups: int = 3,
               num_nh_chains: int = 3, seed: int = 0,
               device="cuda") -> State:
    """A fresh State on ``device`` (velocities default to zero)."""
    device = resolve_device(device)
    pos = torch.as_tensor(np.asarray(positions, np.float32), device=device)
    n = pos.shape[0]
    vel = (torch.zeros((n, 3), dtype=torch.float32, device=device)
           if velocities is None else
           torch.as_tensor(np.asarray(velocities, np.float32), device=device))
    z = dict(dtype=torch.float32, device=device)
    return State(
        pos=pos, pos_err=torch.zeros_like(pos), vel=vel,
        box=torch.as_tensor(np.asarray(box, np.float32), device=device),
        nh_eta=torch.zeros((n_temp_groups, num_nh_chains), **z),
        nh_eta_dot=torch.zeros((n_temp_groups, num_nh_chains + 1), **z),
        nh_eta_dotdot=torch.zeros((n_temp_groups, num_nh_chains), **z),
        generator=_generator(device, seed))


def state_from_numpy(obj, device="cuda", seed: int = 0) -> State:
    """A port ``State`` from any object with the JAX ``State`` field names.
    A JAX threefry key has no torch counterpart, so the generator is
    seeded from ``seed``."""
    device = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.array(getattr(obj, name), np.float32),
                               device=device)
    return State(
        pos=t("pos"), pos_err=t("pos_err"), vel=t("vel"), box=t("box"),
        nh_eta=t("nh_eta"), nh_eta_dot=t("nh_eta_dot"),
        nh_eta_dotdot=t("nh_eta_dotdot"),
        generator=_generator(device, seed),
        step=int(np.asarray(obj.step)), time=float(np.asarray(obj.time)),
        cos_v=float(np.asarray(obj.cos_v)))


def set_velocities_to_temperature(system: System, state: State,
                                  temperature: float,
                                  seed: int = 12345) -> State:
    """Maxwell-Boltzmann velocities (massless particles get zero), drawn
    from a ``torch.Generator`` on the state's device."""
    dev = state.pos.device
    g = _generator(dev, seed)
    sigma = torch.sqrt(BOLTZ * temperature * torch.as_tensor(
        np.asarray(system.inv_masses, np.float32), device=dev))[:, None]
    vel = sigma * torch.randn((system.n_atoms, 3), generator=g,
                              dtype=torch.float32, device=dev)
    return state.replace(vel=vel)
