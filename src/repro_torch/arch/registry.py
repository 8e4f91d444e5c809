"""The GPU architecture registry: one :class:`Arch` descriptor per backend.

RegDem is a SASS-level binary translation, so everything about it is
architecture-specific: the control-word layout, the scoreboard-barrier
count, register-file banking, functional-unit latencies/throughputs, and
the occupancy limits whose cliffs the whole optimization chases.  The
:class:`Arch` descriptor gathers those properties into one object that
parameterizes every layer of the stack:

* :mod:`repro_torch.binary` — per-arch text-section codec (control-word layout),
  the v3 container's per-kernel arch tag;
* :mod:`repro_torch.core.sched` / :mod:`repro_torch.core.passes` — barrier count,
  fixed latencies, register banking for RDV placement;
* :mod:`repro_torch.core.simulator` / :mod:`repro_torch.core.predictor` — unit lanes
  (issue intervals / throughput ratios), signal latencies, issue width;
* :mod:`repro_torch.core.occupancy` / :mod:`repro_torch.core.spillspace` — the
  :class:`~repro_torch.core.occupancy.SMConfig` limits and the shared-memory
  spill budget.

Kernels carry their architecture as a registry name
(:attr:`repro_torch.core.isa.Kernel.arch`, default ``"maxwell"``); every
consumer resolves the descriptor through :func:`arch_of`.  Registering a
new architecture is the extension point — see README "Architectures".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Tuple

from repro_torch.core.isa import Instr, RZ, OpClass
from repro_torch.core.occupancy import SMConfig


class ArchError(ValueError):
    """Unknown architecture name or invalid registration."""


@dataclass(frozen=True)
class LatencyModel:
    """Producer->consumer / completion latencies in cycles, per arch.

    ``alu``/``control``/``misc`` are the fixed-latency classes the
    scheduler separates with stall counts; ``fp64``/``sfu`` and the three
    memory spaces signal scoreboard barriers at these latencies.
    ``read_release`` caps how soon a read barrier (store operand release)
    signals after issue.
    """

    alu: int
    control: int
    misc: int
    fp64: int
    sfu: int
    shared: int
    local: int
    global_mem: int
    read_release: int = 20


@dataclass(frozen=True, eq=False)
class Arch:
    """One GPU architecture: codec + machine model + occupancy limits.

    Instances are registry singletons (identity hash/eq); resolve them via
    :func:`get_arch` / :func:`arch_of`, never by constructing duplicates.
    """

    name: str
    full_name: str
    #: example chips / compute capabilities (documentation only)
    chips: Tuple[str, ...]
    sm: SMConfig
    latency: LatencyModel
    #: functional-unit lanes per SM, per op class (issue interval is
    #: ``32 / lanes``; throughput ratio is ``max_lanes / lanes``)
    lanes: Mapping[OpClass, int]
    #: text-section codec (control-word layout); resolved lazily by name
    #: from repro_torch.binary.archcodec to keep this module import-light
    codec: object = field(repr=False, default=None)
    num_barriers: int = 6
    num_reg_banks: int = 4
    num_smem_banks: int = 32
    #: warp schedulers per SM and issues per scheduler per cycle
    #: (Volta/Turing removed dual-issue: one instruction per scheduler)
    schedulers: int = 4
    dual_issue: bool = False
    #: modelled SM issue width (warp-instructions per cycle)
    issue_width: int = 4
    #: per-block shared-memory budget demotion may spill into
    smem_spill_limit: int = 48 * 1024
    #: architectural per-thread register ceiling (R0..Rn-1; the 256th
    #: encoding slot is RZ on every generation modelled here)
    max_regs_per_thread: int = 255
    aliases: Tuple[str, ...] = ()

    # -- derived model queries -------------------------------------------------

    @property
    def max_lanes(self) -> int:
        return max(self.lanes.values())

    def issue_interval(self, klass: OpClass) -> float:
        """Cycles between warp-instructions of ``klass`` (32 / unit lanes)."""
        return 32 / self.lanes[klass]

    def throughput_ratio(self, klass: OpClass) -> float:
        """Contention term of predictor eq. 2: max_lanes / unit lanes."""
        return self.max_lanes / self.lanes[klass]

    def fixed_latency(self, klass: OpClass) -> int:
        """Producer->consumer latency of non-barrier (pipelined) classes."""
        if klass in (OpClass.FP32, OpClass.INT):
            return self.latency.alu
        if klass is OpClass.CONTROL:
            return self.latency.control
        if klass is OpClass.MISC:
            return self.latency.misc
        return self.residual_latency(klass)

    def signal_latency(self, klass: OpClass) -> int:
        """Write-barrier signal latency (producer completion) per class."""
        if klass is OpClass.LSU_GLOBAL:
            return self.latency.global_mem
        if klass is OpClass.LSU_LOCAL:
            return self.latency.local
        if klass is OpClass.LSU_SHARED:
            return self.latency.shared
        return self.residual_latency(klass)

    def residual_latency(self, klass: OpClass) -> int:
        """Barrier-tracker residual latency: what a reused barrier's setter
        still owes.  Local memory is charged at DRAM latency here (the
        tracker is conservative), matching the paper's Fig. 3 machinery."""
        if klass in (OpClass.LSU_GLOBAL, OpClass.LSU_LOCAL):
            return self.latency.global_mem
        if klass is OpClass.LSU_SHARED:
            return self.latency.shared
        if klass is OpClass.FP64:
            return self.latency.fp64
        if klass is OpClass.SFU:
            return self.latency.sfu
        if klass is OpClass.MISC:
            return self.latency.misc
        if klass is OpClass.CONTROL:
            return self.latency.control
        return self.latency.alu

    # -- register banking ------------------------------------------------------

    def reg_bank(self, reg: int) -> int:
        """Register-file bank of ``reg`` (Maxwell: 4 banks; Volta: 2)."""
        return reg % self.num_reg_banks

    def bank_conflicts(self, ins: Instr) -> int:
        """Serialized extra cycles from same-bank source operands."""
        if self.num_reg_banks == 4:
            # the Instr-level cache computes exactly this banking
            return ins.reg_bank_conflicts()
        banks: Dict[int, set] = {}
        for r in set(ins.src_words()):
            if r == RZ:
                continue
            banks.setdefault(self.reg_bank(r), set()).add(r)
        return sum(len(v) - 1 for v in banks.values())

    def rdv_banks(self, wide: bool) -> List[int]:
        """Banks RDV may land in (§3.4.1): any bank, but pair demotion
        needs an even-aligned RDV, restricting it to even banks."""
        return [b for b in range(self.num_reg_banks) if not wide or b % 2 == 0]

    def smem_bank(self, byte_addr: int) -> int:
        return (byte_addr // 4) % self.num_smem_banks

    def describe(self) -> Dict[str, object]:
        """JSON-friendly summary (used by ``benchmarks.run --only arch``)."""
        return {
            "full_name": self.full_name,
            "chips": list(self.chips),
            "ctrl_codec": type(self.codec).__name__ if self.codec else None,
            "num_barriers": self.num_barriers,
            "num_reg_banks": self.num_reg_banks,
            "schedulers": self.schedulers,
            "dual_issue": self.dual_issue,
            "issue_width": self.issue_width,
            "regs_per_sm": self.sm.registers,
            "max_warps": self.sm.max_warps,
            "smem_bytes_per_sm": self.sm.smem_bytes,
            "smem_per_block": self.sm.smem_per_block,
            "smem_spill_limit": self.smem_spill_limit,
            "alu_latency": self.latency.alu,
            "shared_latency": self.latency.shared,
            "global_latency": self.latency.global_mem,
            "num_sms": self.sm.num_sms,
        }


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Arch] = {}
_ALIASES: Dict[str, str] = {}


def register_arch(arch: Arch) -> Arch:
    """Register ``arch`` under its name and aliases; returns it."""
    if arch.name in _REGISTRY:
        raise ArchError(f"architecture {arch.name!r} already registered")
    if arch.codec is None:
        raise ArchError(f"architecture {arch.name!r} has no text codec")
    _REGISTRY[arch.name] = arch
    for alias in arch.aliases:
        if alias in _REGISTRY or alias in _ALIASES:
            raise ArchError(f"alias {alias!r} already registered")
        _ALIASES[alias] = arch.name
    return arch


def get_arch(name: str) -> Arch:
    """Resolve an architecture by registry name or alias."""
    key = name.lower()
    key = _ALIASES.get(key, key)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ArchError(
            f"unknown architecture {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def arch_names() -> List[str]:
    """Registered canonical architecture names, sorted."""
    return sorted(_REGISTRY)


def arch_of(kernel) -> Arch:
    """The :class:`Arch` a kernel is encoded/scheduled for."""
    return get_arch(getattr(kernel, "arch", "maxwell"))
