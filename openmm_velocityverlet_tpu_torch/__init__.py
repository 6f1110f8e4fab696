"""openmm_velocityverlet_tpu_torch — the PyTorch/CUDA port of
``openmm_velocityverlet_tpu``.

Module names and layout follow the JAX package, which stays the reference.
The port carries the middle-scheme TGNH step; its hand-written CUDA kernels
for Hopper are B1, the plist pair sweep (``csrc/plist_pair.cu``), B2, the
upper-triangle band / full sweep (``csrc/tri_pair.cu``), and B4/B5, the
fused exact-k reciprocal (``csrc/ewald_fused.cu``), each with a plain torch
version for CPU tensors.  Entry points run on the card unless given
``device="cpu"``.  The package imports torch and numpy, never jax.
"""
from .context import Context
from .forces import ForceEvaluator
from .integrators.vv import VVIntegrator
from .models.builder import SystemBuilder
from .system import (State, System, make_state, state_from_numpy,
                     system_from_numpy)

__all__ = ["Context", "ForceEvaluator", "VVIntegrator", "SystemBuilder",
           "State", "System", "make_state", "state_from_numpy",
           "system_from_numpy"]
