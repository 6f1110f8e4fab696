"""Constant-voltage EDL electrostatics analysis (pure numpy, host-side;
counterpart of ``openmm_velocityverlet_tpu/edl_analysis.py``, the same
functions on the same float64 arithmetic).

Closes the loop on the image-charge constant-voltage method
(reference README.md:148-170; Gong & Padua, JPCC 2019): given the
time-averaged charge-density profile rho_q(z) of the FULL doubled cell
(liquid + images + electrode atoms), integrate Poisson with periodic
boundary conditions and recover

  * the potential drop between the two conductor planes (z = 0 and
    z = mirror; the second plane at z = 0 exists because the periodic
    replica of the single explicit mirror reflects across the cell
    boundary as well),
  * the induced electrode surface-charge density and cell capacitance.

Conventions an earlier analysis got wrong (results/edl_closure_r4_200ps.json
recovered 0.143 V of 1 V applied):

1. The cumulative-sum field lives on BIN EDGES: E[k] = field at
   z = (k+1)*dz.  Evaluating phi at the conductor planes with
   bin-CENTER indexing misses by one bin exactly where |E| is largest
   (~2.2 V/nm at the plane), a ~0.14 V error per plane.
2. phi is NOT periodic when a uniform applied field is present
   (phi(lz) - phi(0) = -E_app*lz); the drop must be measured one-sidedly
   from the liquid side of each plane.
3. "Field inside the electrode ~ 0" is false for atomistic electrodes:
   the slab interior carries real atomic dipole-layer fields of several
   V/nm.  The conductor condition lives at the mirror PLANES, where the
   image antisymmetry forces the induced drop to vanish identically.

With these fixed, that 200 ps profile closes at 1.0002 V of the
1 V applied and the two capacitance estimators agree within ~6%
(results/edl_closure_r5_reanalysis.json).
"""
from __future__ import annotations

import numpy as np

EPS0 = 0.05526349406  # vacuum permittivity, e / (V nm)
_E_TO_UF_CM2 = 1.602176634e-19 / 1e-14 * 1e6  # e/(V nm^2) -> uF/cm^2


def poisson_profile(rho, lz, voltage):
    """Integrate Poisson over the periodic doubled cell.

    Parameters
    ----------
    rho : (nbin,) charge density on uniform bins over [0, lz), e/nm^3.
    lz : box height (nm); mirror plane at lz/2, second plane at 0.
    voltage : applied drop (V); the engine convention is a uniform
        field E_app = 2*V/lz on electrolyte particles
        (reference run-edl.py:97-100).

    Returns dict with bin-edge grids ``z_edge`` (k -> (k+1)*dz),
    ``e_tot`` (V/nm) and ``phi`` (V, phi(0) = 0 on the liquid side),
    plus ``drop_V`` = phi(plane 0, liquid side) - phi(mirror plane).
    """
    rho = np.asarray(rho, np.float64)
    nbin = rho.shape[0]
    dz = lz / nbin
    z_edge = (np.arange(nbin) + 1) * dz
    # E_ind on edges; tin-foil 3D Ewald => zero mean induced field
    e_ind = np.cumsum(rho) * dz / EPS0
    e_ind -= e_ind.mean()
    e_app = 2.0 * voltage / lz
    e_tot = e_ind + e_app
    # phi(0)=0; phi((k+1)dz) = phi(k dz) - E[k]*dz   (liquid side of 0)
    phi = -np.cumsum(e_tot) * dz
    mirror = 0.5 * lz
    k_mirror = int(round(mirror / dz)) - 1        # edge index of z=mirror
    drop = 0.0 - phi[k_mirror]
    # induced-only drop must vanish by image antisymmetry
    phi_ind = -np.cumsum(e_ind) * dz
    drop_ind = 0.0 - phi_ind[k_mirror]
    return {
        "z_edge": z_edge,
        "e_tot": e_tot,
        "phi": phi,
        "drop_V": float(drop),
        "drop_induced_V": float(drop_ind),
        "e_plane0_liquid_V_nm": float(e_tot[:2].mean()),
    }


def antisymmetry_residual(rho):
    """Relative rms deviation of rho from the image antisymmetry
    rho(lz - z) = -rho(z) (exact for the liquid+image part by
    construction; electrode dipole layers add a small symmetric part).
    0 = perfect; ~1 = no antisymmetry."""
    rho = np.asarray(rho, np.float64)
    resid = rho + rho[::-1]
    denom = 2.0 * max(float(rho.std()), 1e-30)
    return float(resid.std() / denom)


def capacitance_dipole(pos_z, charges, liquid_mask, d_sep, voltage, area):
    """Cell capacitance from the parallel-plate induced-charge theorem:
    the plane at z=0 carries Q0 = sum_i q_i z_i / d for a NEUTRAL liquid
    (Green's function of two grounded planes), so C = |M_z|/(d*V*A).
    Position-based: no binning error.  Returns (sigma e/nm^2, C uF/cm^2).
    """
    mz = float(np.sum(charges[liquid_mask] * pos_z[liquid_mask]))
    sigma = mz / d_sep / area
    return sigma, abs(sigma) / voltage * _E_TO_UF_CM2


def capacitance_plane_field(prof, voltage):
    """Cell capacitance from the field at the conductor plane: in the
    thin vacuum gap between the plane and the first atom layer,
    E = sigma_plate/EPS0 (all induced plate charge is 'behind' the
    plane in image space).  Uses the first two bins past z=0."""
    sigma = EPS0 * prof["e_plane0_liquid_V_nm"]
    return float(sigma), float(abs(sigma) / voltage * _E_TO_UF_CM2)
