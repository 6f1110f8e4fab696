"""openmm_velocityverlet_tpu_torch — the PyTorch/CUDA port of
``openmm_velocityverlet_tpu``.

Module names and layout follow the JAX package, which stays the reference.
This slice carries the middle-scheme TGNH main path; the plist pair sweep
runs as kernel B1, hand-written CUDA for Hopper (``csrc/plist_pair.cu``),
with a plain torch version for CPU tensors.  The package imports torch and
numpy, never jax.
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
