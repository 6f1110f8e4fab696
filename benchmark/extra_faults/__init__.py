"""Faults of one configuration beside the six of ``benchmark/faults.py``,
one module a configuration, named by the configuration's ``faults``."""
