"""openmm_velocityverlet_tpu_torch — the PyTorch/CUDA port of
``openmm_velocityverlet_tpu``.

Module names and layout follow the JAX package, which stays the reference.
The port carries the middle and vanilla VV schemes with the TGNH and
partitioned Langevin thermostats, the E-field and cosine acceleration,
image-charge constant voltage with the external-force toolbox
(``ops/external.py``, ``models/helper.py``, ``edl_analysis.py``), the
Monte Carlo barostat, FFT PME, NBTHOLE, CMAP and GB implicit solvent, and
the CHARMM loaders (``models/prmfile.py``, ``psffile.py``, ``grofile.py``,
``replicate.py``), the application layer (``app.py``: ``Simulation``,
the L-BFGS minimizer, checkpoints and reporters), the workload scripts
(``examples/run_bulk.py``, ``examples/run_edl.py``), the multi-device mesh
over ``torch.distributed`` (``parallel/mesh.py``, ``Context(mesh=...)``)
and the closed-form term energies (``ops/bonded.py``, ``ops/drude.py``).
Its hand-written CUDA kernels for Hopper are B1, the plist pair sweep
(``csrc/plist_pair.cu``), B2, the upper-triangle band / full sweep
(``csrc/tri_pair.cu``), B3, the rectangular sweep (``csrc/rect_pair.cu``),
B4/B5, the fused exact-k reciprocal (``csrc/ewald_fused.cu``), and B6-B8,
the gathers of the gather tool (``csrc/gather.cu``), each with a plain torch
version for CPU tensors.  Entry points run on the card unless given
``device="cpu"``.  The package imports torch and numpy, never jax.
"""
from .context import Context
from .forces import ForceEvaluator
from .integrators.barostat import BarostatConfig
from .integrators.vv import VVIntegrator
from .models.builder import SystemBuilder
from .system import (State, System, make_state, state_from_numpy,
                     system_from_numpy)

__all__ = ["Context", "ForceEvaluator", "VVIntegrator", "BarostatConfig",
           "SystemBuilder",
           "State", "System", "make_state", "state_from_numpy",
           "system_from_numpy"]
