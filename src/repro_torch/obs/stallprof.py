"""Stall-attribution profiles: where the simulator's stall cycles went.

RegDem's predictor (arXiv 1907.02894 §5) models *aggregate* instruction
stalls; this module keeps the books per **static instruction** and per
**reason**, from the event-driven simulator's own idle accounting:

* ``memory_latency`` — a warp sat on a scoreboard barrier set by a memory
  instruction (the LDG/LDS/LDL whose latency the schedule failed to hide);
* ``barrier_wait``   — same, but the setter was a compute producer
  (FP64/SFU/long-latency ALU);
* ``unit_busy``      — a warp was ready but its functional unit had no
  issue capacity left (the §5.5 ``md`` story: FP64-bound kernels gain
  nothing from occupancy because this bucket dominates);
* ``bank_conflict``  — blocked re-issuing behind an operand-read extended
  by register-bank conflicts;
* ``issue_stall``    — blocked by the instruction's own scheduled stall
  count (fixed-latency dependencies).

The attribution is **exact by construction**: every idle cycle the engine
counts lands in exactly one ``(instruction, reason)`` bucket, so
``profile.total == SimResult.issue_stalls`` always — pinned across all nine
paper benchmarks × every architecture by ``tests/test_stall_profile.py``.

This module is deliberately dependency-free (no ``repro_torch.core`` imports):
the simulator imports it, never the reverse.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: Attribution reasons, display order.
REASONS: Tuple[str, ...] = (
    "memory_latency",
    "barrier_wait",
    "unit_busy",
    "bank_conflict",
    "issue_stall",
)

R_MEM, R_BAR, R_UNIT, R_BANK, R_STALL = REASONS


def _short(ins) -> str:
    """One instruction as short display text (control comment stripped)."""
    text = ins.render()
    if text.startswith("/*"):
        end = text.find("*/")
        if end != -1:
            text = text[end + 2 :].lstrip()
    return text


@dataclass
class InstrStall:
    """Stall cycles attributed to one static instruction."""

    #: static instruction index (the annotated-disassembly line order)
    index: int
    op: str
    total: int
    reasons: Dict[str, int] = field(default_factory=dict)

    @property
    def top_reason(self) -> str:
        return max(self.reasons, key=lambda r: (self.reasons[r], r)) if self.reasons else ""

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "op": self.op,
            "total": self.total,
            "reasons": dict(sorted(self.reasons.items())),
        }


@dataclass
class StallProfile:
    """Per-instruction, per-reason attribution of one simulation's stalls."""

    kernel_name: str
    arch: str
    #: total attributed stall cycles — exactly ``SimResult.issue_stalls``
    total: int
    per_reason: Dict[str, int]
    #: nonzero entries only, in static program order
    instructions: List[InstrStall]

    def hot(self, n: int = 5) -> List[InstrStall]:
        """The ``n`` most stall-expensive instructions."""
        return sorted(self.instructions, key=lambda e: (-e.total, e.index))[:n]

    def by_index(self) -> Dict[int, InstrStall]:
        return {e.index: e for e in self.instructions}

    def share(self, entry: InstrStall) -> float:
        return entry.total / self.total if self.total else 0.0

    def to_json(self) -> dict:
        return {
            "kernel": self.kernel_name,
            "arch": self.arch,
            "total": self.total,
            "per_reason": {r: self.per_reason.get(r, 0) for r in REASONS},
            "instructions": [e.to_json() for e in self.instructions],
        }

    def render(self, top: int = 8) -> str:
        """Human-readable summary: reason mix, then the hottest lines."""
        lines = [
            f"stall profile {self.kernel_name} (arch={self.arch}): "
            f"{self.total} stall cycles"
        ]
        for r in REASONS:
            c = self.per_reason.get(r, 0)
            if c:
                lines.append(f"  {r:<14s} {c:>10d}  {c / self.total:6.1%}")
        for e in self.hot(top):
            lines.append(
                f"  /*{e.index:04d}*/ {e.op:<40.40s} {e.total:>10d} "
                f"{self.share(e):6.1%}  {e.top_reason}"
            )
        return "\n".join(lines)


def build_profile(
    kernel, blame: Dict[Tuple[int, str], int], total: int
) -> StallProfile:
    """Resolve an engine blame map ``{(instr_uid, reason): cycles}`` against
    the kernel's static instruction stream.

    ``total`` is the engine's aggregate idle count; a mismatch with the
    blame sum is an attribution bug and raises immediately rather than
    shipping books that don't balance.
    """
    attributed = sum(blame.values())
    if attributed != total:
        raise AssertionError(
            f"{kernel.name}: stall attribution does not balance: "
            f"{attributed} attributed vs {total} counted"
        )
    by_uid: Dict[int, Dict[str, int]] = {}
    for (uid, reason), cycles in blame.items():
        if cycles:
            bucket = by_uid.setdefault(uid, {})
            bucket[reason] = bucket.get(reason, 0) + cycles

    per_reason: Dict[str, int] = {}
    instructions: List[InstrStall] = []
    index = 0
    for it in kernel.items:
        if not hasattr(it, "ctrl"):  # Label
            continue
        reasons = by_uid.pop(it.uid, None)
        if reasons:
            instructions.append(
                InstrStall(
                    index=index,
                    op=_short(it),
                    total=sum(reasons.values()),
                    reasons=dict(sorted(reasons.items())),
                )
            )
            for r, c in reasons.items():
                per_reason[r] = per_reason.get(r, 0) + c
        index += 1
    if by_uid:
        raise AssertionError(
            f"{kernel.name}: blame refers to {len(by_uid)} instruction(s) "
            "not in the kernel's static stream"
        )
    return StallProfile(
        kernel_name=kernel.name,
        arch=getattr(kernel, "arch", "maxwell"),
        total=total,
        per_reason=per_reason,
        instructions=instructions,
    )
