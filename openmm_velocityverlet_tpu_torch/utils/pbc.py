"""Periodic-boundary math for orthorhombic boxes (counterpart of
``openmm_velocityverlet_tpu/utils/pbc.py``).  ``box`` is a (3,) tensor of
box lengths."""
from __future__ import annotations

import torch


def minimum_image(dr: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Wrap (..., 3) displacements into the minimum image.  torch.round
    rounds half to even, as jnp.round does."""
    return dr - box * torch.round(dr / box)


def wrap_positions(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Wrap positions into [0, box)."""
    return pos - box * torch.floor(pos / box)


def distance2(dr: torch.Tensor) -> torch.Tensor:
    return torch.sum(dr * dr, dim=-1)
