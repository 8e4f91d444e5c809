"""Hand-written GPU kernels of the port, their wrappers and plain versions.

``ops`` is the public surface (model-layout entry points); ``ref`` holds the
oracles; ``flash_attention`` the attention wrapper, plain version and tile
chooser; ``_build`` compiles ``csrc/*.cu`` at first use.  Importing any of
them compiles nothing.
"""

from . import flash_attention, ops, ref

__all__ = ["flash_attention", "ops", "ref"]
