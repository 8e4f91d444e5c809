"""Hand-written GPU kernels of the port, their wrappers and plain versions.

``ops`` is the public surface (model-layout entry points); ``ref`` holds the
oracles; ``flash_attention`` the attention wrapper, plain version and tile
chooser; ``mamba2_ssd`` the SSD scan's wrapper and plain version;
``train_attention`` training attention's forward and backward (an autograd
function) and their plain version; ``_build``
compiles ``csrc/*.cu`` at first use.  Importing any of
them compiles nothing.
"""

from . import flash_attention, mamba2_ssd, ops, ref, train_attention

__all__ = ["flash_attention", "mamba2_ssd", "ops", "ref", "train_attention"]
