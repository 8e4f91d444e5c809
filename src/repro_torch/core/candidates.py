"""Candidate-register selection for demotion (paper §3.4.3).

Three strategies, each estimating register access counts; candidates are
chosen in *ascending* order of the estimate (cheapest-to-demote first):

* ``static``   one pass over the assembly, counting static accesses;
* ``cfg``      per-basic-block counts, blocks inside loops weighted x10;
* ``conflict`` ascending number of operand conflicts (ties: static count).

Excluded from candidacy: live-in/live-out (ABI) registers, RZ, and the odd
alias words of 64-bit pairs (pairs are demoted through their leading word).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from .isa import CFG, RZ, Kernel

STRATEGIES = ("static", "cfg", "conflict")

#: Generic loop weight (paper §3.4.3 / §4: "a generic value of 10").
LOOP_FACTOR = 10


def width_map(kernel: Kernel) -> Dict[int, int]:
    """reg -> operand width (2 for 64-bit pairs), by leading register.

    Merges the per-instruction ``width_entries`` (cached on the instruction
    alongside its operand words: address operands of memory ops contribute
    width 1, everything else its opcode width) with ``max`` — the demotion
    pipeline recomputes this map after every mutation, so only instructions
    actually touched by a rename pay the re-parse."""
    widths: Dict[int, int] = {}
    get = widths.get
    for ins in kernel.instructions():
        for r, w in ins.width_entries():
            if w > get(r, 0):
                widths[r] = w
    return widths


def operand_conflicts(kernel: Kernel) -> Dict[int, Set[int]]:
    """reg -> set of registers co-occurring in the same instruction.

    Two demoted registers appearing in one instruction would need two value
    temporaries (an *operand conflict*, §3.1 challenge 2), so after demoting
    ``r`` every conflicting candidate is dropped.
    """
    conf: Dict[int, Set[int]] = {}
    for ins in kernel.instructions():
        regs = [r for r in ins.leading_regs() if r != RZ]
        for a in regs:
            for b in regs:
                if a != b:
                    conf.setdefault(a, set()).add(b)
    return conf


def _excluded(kernel: Kernel) -> Set[int]:
    widths = width_map(kernel)
    excl: Set[int] = set(kernel.live_in) | set(kernel.live_out) | {RZ}
    if kernel.rda is not None:
        excl.add(kernel.rda)
    # odd alias words of pairs are not independent candidates
    for r, w in widths.items():
        if w == 2:
            excl.add(r + 1)
    return excl


def spillable(kernel: Kernel) -> List[int]:
    """Leading registers eligible for demotion, ascending.

    The strategy-independent candidate pool: everything :func:`make_candidates`
    could ever return, before any cost ordering.  The autotuning search uses
    it to prune kernels with nothing to demote without running a pipeline.
    """
    widths = width_map(kernel)
    excl = _excluded(kernel)
    return [r for r in sorted(widths) if r not in excl]


def order_candidates(kernel: Kernel, ordering: str) -> List[Tuple[int, int]]:
    """The §3.4.3 cost orderings over the spillable pool, by name.

    This is the ordering primitive the strategy registry builds on:
    registered strategies compose an ordering with their own filters (e.g.
    compressed slots keep only width-1 candidates).
    """
    if ordering not in STRATEGIES:
        raise ValueError(
            f"unknown candidate ordering {ordering!r}; want one of {STRATEGIES}"
        )
    widths = width_map(kernel)
    excl = _excluded(kernel)
    regs = [r for r in sorted(widths) if r not in excl]

    if ordering == "static":
        counts = kernel.static_access_counts()
        key = lambda r: (counts.get(r, 0), r)
    elif ordering == "cfg":
        cfg = CFG(kernel)
        weighted: Dict[int, float] = {}
        for blk in cfg.blocks:
            w = LOOP_FACTOR ** blk.loop_depth
            for ins in blk.instrs:
                for r in ins.leading_regs():
                    weighted[r] = weighted.get(r, 0.0) + w
        key = lambda r: (weighted.get(r, 0.0), r)
    else:  # conflict
        conf = operand_conflicts(kernel)
        counts = kernel.static_access_counts()
        key = lambda r: (len(conf.get(r, ())), counts.get(r, 0), r)

    return [(r, widths[r]) for r in sorted(regs, key=key)]


def make_candidates(kernel: Kernel, strategy: str) -> List[Tuple[int, int]]:
    """Ordered demotion queue: list of (leading_reg, width).

    ``strategy`` resolves through the registry
    (:func:`repro_torch.core.strategies.get_strategy`), so any registered name —
    paper ordering or new family — is valid here; the paper's three names
    keep their historical byte-identical orderings.
    """
    from .strategies import get_strategy

    return get_strategy(strategy).select(kernel)
