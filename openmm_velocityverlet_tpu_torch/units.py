"""MD unit system and physical constants (counterpart of
``openmm_velocityverlet_tpu/units.py``; the values are identical).

The engine works in the OpenMM MD unit system, the one the reference plugin
uses (VVIntegrator.cpp:40, ``SimTKOpenMMRealType.h`` BOLTZ):

* length      : nanometer (nm)
* time        : picosecond (ps)
* mass        : dalton (g/mol)
* energy      : kilojoule/mole (kJ/mol)
* charge      : elementary charge (e)
* temperature : kelvin (K)

Derived: velocity nm/ps, force kJ/mol/nm, frequency 1/ps.
"""

# Molar gas constant in kJ/mol/K ("BOLTZ" in OpenMM's SimTKOpenMMRealType.h).
BOLTZ = 8.31446261815324e-3

# Coulomb constant 1/(4 pi eps0) in kJ*nm/mol/e^2.
ONE_4PI_EPS0 = 138.935456

# Avogadro constant, 1/mol.
AVOGADRO = 6.02214076e23

# 1 volt/nm in the integrator's internal E-field unit kJ/(nm e).
VOLT_PER_NM = 1.602176634e-22

# Unit conversion helpers (CHARMM parameter files use kcal/mol and Angstrom).
KCAL_TO_KJ = 4.184
ANGSTROM_TO_NM = 0.1
DEGREE_TO_RAD = 3.14159265358979323846 / 180.0

PI = 3.14159265358979323846

# Pressure: bar -> kJ/mol/nm^3.
BAR_TO_KJ_MOL_NM3 = 0.06022140760


def ns_per_day(steps_per_second: float, dt_ps: float) -> float:
    """ns/day for a given steps/s and dt (ps)."""
    return steps_per_second * dt_ps * 1e-3 * 86400.0
