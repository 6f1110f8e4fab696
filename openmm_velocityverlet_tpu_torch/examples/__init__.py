"""The workload scripts of the port: ``run_bulk`` and ``run_edl``, twins of
``examples/run-bulk.py`` and ``examples/run-edl.py``.  Run them as
``python -m openmm_velocityverlet_tpu_torch.examples.run_bulk --help``."""
