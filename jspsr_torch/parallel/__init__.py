"""Data-parallel training over processes and tile-parallel inference over
local devices (``mesh.py``), and the multi-process check ``dryrun.py``."""
