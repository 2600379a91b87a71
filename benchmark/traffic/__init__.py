"""Traffic: ``<traffic>.json`` files of parameters, read by the one
generator ``generate.py``."""
