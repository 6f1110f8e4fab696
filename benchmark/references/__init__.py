"""Plain references of the port's timed path, one module a configuration,
named by the configuration's ``reference``."""
