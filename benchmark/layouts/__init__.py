"""Numpy builders of a configuration's tables, one module a layout."""
