"""repro_torch.arch — the GPU architecture registry.

Two backends ship in-tree:

* ``maxwell`` — the paper's Maxwell/Pascal model (bundled 21-bit control
  words, 4 register banks, 48 KiB shared per block);
* ``volta`` — a Volta/Turing model after TuringAs (128-bit instructions
  with in-word control fields, 2 register banks, dual-issue removed,
  96 KiB shared carve-out).

Kernels name their architecture (:attr:`repro_torch.core.isa.Kernel.arch`);
:func:`arch_of` resolves the descriptor that parameterizes scheduling,
simulation, occupancy, spilling, and the binary codec.  :func:`retarget`
ports a kernel to another architecture by re-scheduling it under that
arch's machine model.
"""

from .registry import (
    Arch,
    ArchError,
    LatencyModel,
    arch_names,
    arch_of,
    get_arch,
    register_arch,
)
from .maxwell import MAXWELL_ARCH
from .volta import VOLTA_ARCH


def retarget(kernel, arch) -> "object":
    """Port a kernel to another architecture.

    Copies the kernel, tags it with the target arch, and re-runs the
    control-word scheduler under that arch's machine model (barrier count,
    fixed latencies) — the moral equivalent of recompiling the same
    program for a new GPU generation.  The input kernel is not mutated.
    """
    from repro_torch.core.sched import schedule

    target = arch if isinstance(arch, Arch) else get_arch(arch)
    out = kernel.copy()
    out.arch = target.name
    return schedule(out)


__all__ = [
    "Arch",
    "ArchError",
    "LatencyModel",
    "MAXWELL_ARCH",
    "VOLTA_ARCH",
    "arch_names",
    "arch_of",
    "get_arch",
    "register_arch",
    "retarget",
]
