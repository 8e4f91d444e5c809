"""repro_torch — the PyTorch/CUDA port of the ``repro`` model stack.

Sub-packages carry the names of their counterparts in ``repro`` so a reader
finds the other side of a module (``repro_torch/kernels/ops.py`` <->
``repro/kernels/ops.py``).  The package imports ``torch``, never ``jax`` and
nothing of ``repro``.  Every entry point runs on the GPU unless the caller
asks for the CPU (``device="cpu"``); with no CUDA device the default raises.

Ported so far: every family's serving path (``runtime.Server`` ->
``models.Model`` -> ``models.transformer`` / ``mamba2`` / ``hybrid`` /
``encdec`` -> ``kernels.ops`` -> the hand-written CUDA kernels in
``kernels/csrc/``), training on one device and on a mesh (``runtime.Trainer``,
``optim``, ``checkpoint``, ``data``, ``sharding``, ``launch``), and the
framework-free half: the RegDem translator (``core``, ``binary``, ``arch``,
``obs.stallprof``, ``testing``, ``util``, ``runtime.daemon``) and the kernel
corpus it tunes before serving (``data.corpus``), each a copy of the
reference module.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # loaded at first use, so that the framework-free half (``obs``,
    # ``core``, ``binary``) imports no torch
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
