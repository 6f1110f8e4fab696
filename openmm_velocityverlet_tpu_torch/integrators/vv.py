"""VVIntegrator — the user-facing integrator configuration and its
binding to a System (counterpart of
``openmm_velocityverlet_tpu/integrators/vv.py``).

The public API mirrors OpenMM::VVIntegrator (VVIntegrator.h:70-431);
``build_data`` partitions the particles and does the per-temperature-group
DOF bookkeeping on the host, exactly as the JAX version.  The step itself
lives in ``context.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..units import BOLTZ, VOLT_PER_NM

TG_ATOM, TG_COM, TG_DRUDE = 0, 1, 2
NUM_TG_MAX = 3


@dataclasses.dataclass
class IntegratorData:
    """Static tables + parameters produced when the integrator binds to a
    system (the analog of the per-kernel initialize() uploads,
    CudaVVKernels.cpp:462-667)."""

    # scalars
    dt: float
    temperature: float
    frequency: float
    drude_temperature: float
    drude_frequency: float
    friction: float
    drude_friction: float
    num_nh_chains: int
    loops_per_step: int
    use_middle: bool
    use_com_temp_group: bool
    max_drude_distance: float
    cos_acceleration: float
    electric_field: float  # kJ/(nm e)
    mirror_location: float
    num_temp_groups: int

    # NH partition tables
    nh_mask: np.ndarray          # (N,) bool
    nh_normal: np.ndarray        # (Nn,) i32
    nh_pairs: np.ndarray         # (Np,2) i32 (drude, parent)
    nh_mol_mask: np.ndarray      # (M,) bool
    temp_group_nkbt: np.ndarray  # (3,)
    temp_group_dof: np.ndarray   # (3,)
    eta_mass: np.ndarray         # (3,C)
    # Langevin partition
    ld_normal: np.ndarray        # (Ln,) i32
    ld_pairs: np.ndarray         # (Lp,2) i32
    # modifiers
    image_pairs: np.ndarray      # (I,2) i32 (image, parent)
    electrolyte: np.ndarray      # (Ne,) i32
    drude_pairs: np.ndarray      # (D,2) i32 — hardwall domain
    # per-pair spring frequency omega = sqrt(k3/mu) — stability diagnostics
    # (stiffness checks, e.g. tests/test_langevin_mts.py)
    pair_omega: np.ndarray       # (D,)


class VVIntegrator:
    """User-facing integrator object holding configuration before binding.

    Constructor signature mirrors VVIntegrator.cpp:46-70 (temperatures in K,
    frequencies in 1/ps, stepSize in ps).
    """

    def __init__(self, temperature=300.0, frequency=10.0,
                 drude_temperature=1.0, drude_frequency=40.0,
                 step_size=0.001, num_nh_chains=3, loops_per_step=1):
        self.temperature = float(temperature)
        self.frequency = float(frequency)
        self.drude_temperature = float(drude_temperature)
        self.drude_frequency = float(drude_frequency)
        self.step_size = float(step_size)
        self.num_nh_chains = int(num_nh_chains)
        self.loops_per_step = int(loops_per_step)
        self.constraint_tolerance = 1e-5
        self.max_drude_distance = 0.0
        self.friction = 5.0
        self.drude_friction = 20.0
        self.random_number_seed = 0
        self.mirror_location = 0.0
        self.electric_field = 0.0          # internal kJ/(nm e)
        self.cos_acceleration = 0.0        # nm/ps^2
        self.use_com_temp_group = False
        self.use_middle_scheme = True

        self.debug_enabled = False
        self._auto_com_temp_group = True
        self._auto_friction = True
        self.particles_langevin: list = []
        self.particles_electrolyte: list = []
        self.image_pairs: list = []        # (image, parent)

    # ---- reference API surface (VVIntegrator.h:70-431) ----
    def setTemperature(self, t): self.temperature = float(t)
    def getTemperature(self): return self.temperature
    def setFrequency(self, f): self.frequency = float(f)
    def getFrequency(self): return self.frequency
    def setDrudeTemperature(self, t): self.drude_temperature = float(t)
    def getDrudeTemperature(self): return self.drude_temperature
    def setDrudeFrequency(self, f): self.drude_frequency = float(f)
    def getDrudeFrequency(self): return self.drude_frequency
    def setStepSize(self, dt): self.step_size = float(dt)
    def getStepSize(self): return self.step_size
    def setNumNHChains(self, n): self.num_nh_chains = int(n)
    def getNumNHChains(self): return self.num_nh_chains
    def setLoopsPerStep(self, n): self.loops_per_step = int(n)
    def getLoopsPerStep(self): return self.loops_per_step
    def setConstraintTolerance(self, t): self.constraint_tolerance = float(t)
    def getConstraintTolerance(self): return self.constraint_tolerance
    def setMaxDrudeDistance(self, d): self.max_drude_distance = float(d)
    def getMaxDrudeDistance(self): return self.max_drude_distance

    def setFriction(self, f):
        self.friction = float(f)
        self._auto_friction = False

    def getFriction(self): return self.friction

    def setDrudeFriction(self, f): self.drude_friction = float(f)
    def getDrudeFriction(self): return self.drude_friction
    def setRandomNumberSeed(self, s): self.random_number_seed = int(s)
    def getRandomNumberSeed(self): return self.random_number_seed

    def addParticleLangevin(self, p):
        self.particles_langevin.append(int(p))
        return len(self.particles_langevin)

    def getParticlesLD(self): return list(self.particles_langevin)

    def addParticleElectrolyte(self, p):
        self.particles_electrolyte.append(int(p))
        return len(self.particles_electrolyte)

    def getParticlesElectrolyte(self): return list(self.particles_electrolyte)

    def addImagePair(self, image, parent):
        self.image_pairs.append((int(image), int(parent)))
        return len(self.image_pairs)

    def getImagePairs(self): return list(self.image_pairs)

    def setMirrorLocation(self, z): self.mirror_location = float(z)
    def getMirrorLocation(self): return self.mirror_location

    def setElectricField(self, strength_v_per_nm):
        """Stores the field in the reference's internal unit kJ/(nm e)
        (VVIntegrator.h:283-296)."""
        self.electric_field = float(strength_v_per_nm) * VOLT_PER_NM

    def getElectricField(self):
        return self.electric_field / VOLT_PER_NM

    def setCosAcceleration(self, a): self.cos_acceleration = float(a)
    def getCosAcceleration(self): return self.cos_acceleration

    def setUseCOMTempGroup(self, b):
        self.use_com_temp_group = bool(b)
        self._auto_com_temp_group = False

    def getUseCOMTempGroup(self): return self.use_com_temp_group
    def setUseMiddleScheme(self, b): self.use_middle_scheme = bool(b)
    def getUseMiddleScheme(self): return self.use_middle_scheme

    def setAnalyticDrudeSpring(self, b):
        """Deprecated no-op, kept for API compatibility.  The spring-in-
        force middle scheme is stable at omega*dt ~ 1 (trace of the
        kick+drift map is 2 - (omega dt)^2 > -2), and the exact OU velocity
        map holds the Drude bath; splitting the spring out of the force
        (round-1/2 experiments) injected energy through the force terms
        frozen across the rotation and is gone."""

    def getAnalyticDrudeSpring(self): return False
    def setDebugEnabled(self, b): self.debug_enabled = bool(b)
    def getDebugEnabled(self): return self.debug_enabled

    # ---- binding: partition particles, DOF bookkeeping ----
    def build_data(self, system) -> IntegratorData:
        """Create the static IntegratorData for a System.  Follows the
        reference's initialize() sequence: Drude auto-detection
        (VVIntegrator.cpp:96-121), NH/LD partition and validation (:138-155),
        and the per-temperature-group DOF bookkeeping
        (CudaVVKernels.cpp:496-594)."""
        n = system.n_atoms
        masses = np.asarray(system.masses)
        mol_id = np.asarray(system.particle_mol_id)
        mol_mass = np.asarray(system.mol_masses)
        n_mol = len(mol_mass)
        drude_pairs = np.asarray(system.drude_pairs).reshape(-1, 2)
        is_drude_system = drude_pairs.shape[0] > 0

        # auto COM temp group / friction (VVIntegrator.cpp:106-121)
        use_com = self.use_com_temp_group
        if self._auto_com_temp_group:
            use_com = is_drude_system
        friction = self.friction
        if self._auto_friction:
            friction = 5.0 if is_drude_system else 1.0

        ld_set = set(self.particles_langevin)
        img_set = set(i for i, _ in self.image_pairs)
        nh_mask = np.array([(i not in ld_set) and (i not in img_set)
                            for i in range(n)], bool)
        nh_mols = sorted(set(int(mol_id[i]) for i in range(n) if nh_mask[i]))
        nh_mol_mask = np.zeros(n_mol, bool)
        nh_mol_mask[nh_mols] = True
        for i in range(n):
            if (i in ld_set) and nh_mol_mask[mol_id[i]]:
                raise ValueError("NH and Langevin thermostat cannot be applied"
                                 " on the same molecule")
        if ld_set and self.cos_acceleration != 0:
            raise ValueError("Langevin thermostat and periodic perturbation "
                             "shouldn't be used together")

        # split NH particles into normal vs Drude pairs; DOF bookkeeping
        tg_dof = np.zeros(NUM_TG_MAX)
        nh_particle_set = set(int(i) for i in range(n) if nh_mask[i])
        for i in range(n):
            if nh_mask[i] and masses[i] != 0.0:
                tg_dof[TG_ATOM] += 3
                if use_com:
                    tg_dof[TG_ATOM] -= 3 * masses[i] / mol_mass[mol_id[i]]
        nh_pairs, ld_pairs = [], []
        ld_particle_set = set(self.particles_langevin)
        for d, p in drude_pairs:
            d, p = int(d), int(p)
            if nh_mask[d] != nh_mask[p]:
                raise ValueError("Drude particle and its parent atom should "
                                 "be in the same thermostat")
            if nh_mask[d]:
                nh_particle_set.discard(d)
                nh_particle_set.discard(p)
                nh_pairs.append((d, p))
                tg_dof[TG_ATOM] -= 3
                tg_dof[TG_DRUDE] += 3
            else:
                ld_particle_set.discard(d)
                ld_particle_set.discard(p)
                ld_pairs.append((d, p))
        constraints = np.asarray(system.constraints).reshape(-1, 2)
        for a, b in constraints:
            if a < 0:
                continue
            if nh_mask[a] != nh_mask[b]:
                raise ValueError("Constrained particle pair should be in the "
                                 "same thermostat")
            if nh_mask[a]:
                tg_dof[TG_ATOM] -= 1
        if use_com:
            # only molecules with mass carry COM momentum (an all-massless
            # molecule — a mesh-padding ghost — has no COM velocity; the
            # reference never encounters the case, its massless particles
            # are always images or vsites inside massive molecules)
            tg_dof[TG_COM] = 3 * sum(1 for m in nh_mols if mol_mass[m] > 0)
        if system.has_cm_motion_remover:
            if use_com:
                tg_dof[TG_COM] -= 3
            else:
                tg_dof[TG_ATOM] -= 3
        tg_dof = np.maximum(tg_dof, 0.0)

        num_tg = 3
        if tg_dof[TG_DRUDE] == 0:
            num_tg = 2 if tg_dof[TG_COM] > 0 else 1

        # NH chain masses: Q1 = DOF kT / w^2, Qi = kT / w^2
        # (CudaVVKernels.cpp:577-594)
        C = self.num_nh_chains
        real_kt = BOLTZ * self.temperature
        drude_kt = BOLTZ * self.drude_temperature
        eta_mass = np.zeros((NUM_TG_MAX, C))
        nkbt = np.zeros(NUM_TG_MAX)
        for g in range(num_tg):
            kt = drude_kt if g == TG_DRUDE else real_kt
            w = self.drude_frequency if g == TG_DRUDE else self.frequency
            tg_mass = kt / w ** 2
            nkbt[g] = tg_dof[g] * kt
            eta_mass[g, 0] = tg_dof[g] * tg_mass
            eta_mass[g, 1:] = tg_mass

        def arr(x, shape2=None, dtype=np.int32):
            a = np.asarray(sorted(x) if shape2 is None else x, dtype)
            if shape2 is not None:
                a = a.reshape(-1, shape2)
            return a

        masses_np = np.asarray(system.masses, np.float64)
        k3_np = np.asarray(system.drude_k3, np.float64).reshape(-1)
        if drude_pairs.shape[0]:
            m_d = masses_np[drude_pairs[:, 0]]
            m_p = masses_np[drude_pairs[:, 1]]
            mtot = m_d + m_p
            mu = m_d * m_p / mtot
            pair_omega = np.sqrt(np.maximum(k3_np, 0.0) / np.maximum(mu, 1e-12))
        else:
            pair_omega = np.zeros((0,), np.float64)

        return IntegratorData(
            dt=self.step_size,
            temperature=self.temperature, frequency=self.frequency,
            drude_temperature=self.drude_temperature,
            drude_frequency=self.drude_frequency,
            friction=friction, drude_friction=self.drude_friction,
            num_nh_chains=C, loops_per_step=self.loops_per_step,
            use_middle=self.use_middle_scheme,
            use_com_temp_group=use_com,
            max_drude_distance=self.max_drude_distance,
            cos_acceleration=self.cos_acceleration,
            electric_field=self.electric_field,
            mirror_location=self.mirror_location,
            num_temp_groups=num_tg,
            nh_mask=np.asarray(nh_mask),
            nh_normal=arr(nh_particle_set),
            nh_pairs=arr(nh_pairs, 2) if nh_pairs else np.zeros((0, 2), np.int32),
            nh_mol_mask=np.asarray(nh_mol_mask),
            temp_group_nkbt=np.asarray(nkbt, np.float32),
            temp_group_dof=np.asarray(tg_dof, np.float32),
            eta_mass=np.asarray(eta_mass, np.float32),
            ld_normal=arr(ld_particle_set),
            ld_pairs=arr(ld_pairs, 2) if ld_pairs else np.zeros((0, 2), np.int32),
            image_pairs=(arr(self.image_pairs, 2) if self.image_pairs
                         else np.zeros((0, 2), np.int32)),
            electrolyte=arr(self.particles_electrolyte),
            drude_pairs=drude_pairs.astype(np.int32),
            pair_omega=pair_omega.astype(np.float32),
        )
