"""Nose-Hoover chain propagation on the device (counterpart of
``openmm_velocityverlet_tpu/integrators/nhchain.py``): the reference's
host-side ``VVIntegrator::propagateNHChain`` (VVIntegrator.cpp:340-376),
vectorised over the temperature groups (TG_ATOM/TG_COM/TG_DRUDE).  Chain
length and loop count are Python ints, so the loops unroll into a handful
of small tensor ops and the step needs no host round trip.
"""
from __future__ import annotations

import torch

from ..units import BOLTZ


def propagate_nh_chains(eta, eta_dot, eta_dotdot, eta_mass, ke2, ke2_target,
                        t_target, dt, num_chains: int, loops_per_step: int):
    """Advance all chains one thermostat interval; return updated state and
    per-group velocity scale factors.

    eta, eta_dotdot, eta_mass : (G, C) ; eta_dot : (G, C+1)
    ke2, ke2_target, t_target : (G,)   (ke2 = 2*KE of the group)
    """
    dt2 = dt / loops_per_step / 2.0
    dt4 = dt2 / 2.0
    dt8 = dt4 / 2.0
    G, C = eta.shape
    # work on per-chain column lists to keep indexing static
    eta = [eta[:, i] for i in range(C)]
    eta_dot = [eta_dot[:, i] for i in range(C + 1)]
    eta_dotdot = [eta_dotdot[:, i] for i in range(C)]
    q0 = eta_mass[:, 0]
    q0_safe = torch.where(q0 > 0, q0, 1.0)
    eta_mass = torch.where(eta_mass > 0, eta_mass, 1.0)

    factor = torch.ones_like(ke2)
    eta_dotdot[0] = (ke2 - ke2_target) / q0_safe
    for _ in range(loops_per_step):
        expfac = None
        for ich in range(num_chains - 1, -1, -1):
            expfac = torch.exp(-dt8 * eta_dot[ich + 1])
            eta_dot[ich] = (eta_dot[ich] * expfac + eta_dotdot[ich] * dt4) * expfac
        factor = factor * torch.exp(-dt2 * eta_dot[0])
        for ich in range(num_chains):
            eta[ich] = eta[ich] + dt2 * eta_dot[ich]
        eta_dotdot[0] = (ke2 * factor * factor - ke2_target) / q0_safe
        # the reference reuses the last expfac of the downward sweep here
        # (VVIntegrator.cpp:364), i.e. exp(-dt8 * eta_dot[1]) as updated above
        eta_dot[0] = (eta_dot[0] * expfac + eta_dotdot[0] * dt4) * expfac
        for ich in range(1, num_chains):
            expfac = torch.exp(-dt8 * eta_dot[ich + 1])
            eta_dotdot[ich] = (eta_mass[:, ich - 1] * eta_dot[ich - 1] ** 2
                               - BOLTZ * t_target) / eta_mass[:, ich]
            eta_dot[ich] = (eta_dot[ich] * expfac + eta_dotdot[ich] * dt4) * expfac

    # groups with zero chain mass are not thermostated (CudaVVKernels.cpp:729):
    # their factor stays 1 and their chain state stays untouched.
    active = q0 > 0
    factor = torch.where(active, factor, 1.0)
    return (torch.where(active[:, None], torch.stack(eta, 1), 0.0),
            torch.where(active[:, None], torch.stack(eta_dot, 1), 0.0),
            torch.where(active[:, None], torch.stack(eta_dotdot, 1), 0.0),
            factor)
