"""Wirings: each hands a configuration's tables to the port's public API,
one module a configuration, named by the configuration's ``wiring``."""
