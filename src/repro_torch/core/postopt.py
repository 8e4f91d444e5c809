"""Post-spilling optimizations (paper §3.4.2).

Three passes over a demoted kernel:

* :func:`eliminate_redundant` — drop demoted loads whose value is already in
  the value register, and demoted stores overwritten before any reload;
* :func:`reschedule` — hoist demoted loads as early as legally possible and
  relax the read barrier of demoted stores whose value register is never
  rewritten in the barrier scope;
* :func:`substitute_value_register` — per-block liveness finds free
  registers; distinct demoted-access *spans* get distinct temporaries so
  several demoted values can be in flight simultaneously.

All passes maintain the barrier-consistency invariant checked by
:func:`repro_torch.core.sched.verify_schedule`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from .isa import RZ, Instr, Kernel, Label, liveness
from .sched import fixup_stalls


def _scopes(items: List[object]) -> List[List[int]]:
    """Indices of instructions grouped by barrier scope (label/branch walls)."""
    out: List[List[int]] = []
    cur: List[int] = []
    for i, it in enumerate(items):
        if isinstance(it, Label):
            if cur:
                out.append(cur)
            cur = []
            continue
        cur.append(i)
        if it.info.is_branch or it.info.is_exit:
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    return out


def _remove_barrier_waits(items: List[object], scope: List[int], start: int, bars: Set[int]) -> None:
    """Remove waits on ``bars`` from instructions after position ``start`` in
    ``scope``, stopping per-barrier once another setter re-arms it."""
    live = set(bars)
    for idx in scope:
        if idx <= start or not live:
            continue
        ins: Instr = items[idx]
        if ins is None:  # already deleted in this pass
            continue
        ins.ctrl.wait -= live
        for b in list(live):
            if ins.ctrl.write_bar == b or ins.ctrl.read_bar == b:
                live.discard(b)


def _delete(kernel: Kernel, idx: int, scope: List[int]) -> None:
    """Delete instruction ``idx``, transferring its wait mask forward and
    cleaning up waits on the barriers it used to set."""
    ins: Instr = kernel.items[idx]
    sets = {b for b in (ins.ctrl.write_bar, ins.ctrl.read_bar) if b is not None}
    if sets:
        _remove_barrier_waits(kernel.items, scope, idx, sets)
    if ins.ctrl.wait:
        # transfer hazard waits to the next surviving instruction; if none
        # remains in the scope they protected only the deleted instruction
        for j in scope:
            if j > idx and kernel.items[j] is not None:
                kernel.items[j].ctrl.wait |= ins.ctrl.wait
                break
    kernel.items[idx] = None  # type: ignore[assignment]


def _commit_deletes(kernel: Kernel) -> None:
    kernel.items = [it for it in kernel.items if it is not None]


# ---------------------------------------------------------------------------
# Pass 1: eliminating redundant demote code
# ---------------------------------------------------------------------------


def eliminate_redundant(kernel: Kernel, rdv: int) -> int:
    """Remove provably redundant demoted loads/stores; returns #removed."""
    removed = 0
    items = kernel.items
    for scope in _scopes(items):
        # (a) redundant loads: RDV already holds this demoted word
        holds: Dict[int, int] = {}  # value-reg -> smem offset it holds
        for idx in scope:
            ins: Instr = items[idx]
            if ins is None:
                continue
            if ins.tag == "demoted_load":
                vreg = ins.dsts[0]
                if holds.get(vreg) == ins.offset:
                    _delete(kernel, idx, scope)
                    removed += 1
                    continue
                if ins.pred is None:
                    holds[vreg] = ins.offset
                else:
                    holds.pop(vreg, None)
            elif ins.tag == "demoted_store":
                vreg = ins.srcs[1]
                if ins.pred is None:
                    holds[vreg] = ins.offset
                else:
                    holds.pop(vreg, None)
            else:
                for r in ins.dst_words():
                    holds.pop(r, None)
        # (b) dead stores: overwritten before any reload of the same word
        for pos, idx in enumerate(scope):
            ins = items[idx]
            if ins is None or getattr(ins, "tag", None) != "demoted_store" or ins.pred is not None:
                continue
            for later_idx in scope[pos + 1 :]:
                later = items[later_idx]
                if later is None:
                    continue
                if later.tag == "demoted_load" and later.offset == ins.offset:
                    break
                if (
                    later.tag == "demoted_store"
                    and later.offset == ins.offset
                    and later.pred is None
                ):
                    _delete(kernel, idx, scope)
                    removed += 1
                    break
    _commit_deletes(kernel)
    return removed


# ---------------------------------------------------------------------------
# Pass 2: updating the instruction schedule
# ---------------------------------------------------------------------------


def reschedule(kernel: Kernel, rdv: int, rda: int, max_hoist: int = 8) -> int:
    """Hoist demoted loads earlier; relax demoted-store read barriers."""
    moved = 0
    items = kernel.items

    # --- store barrier relaxation -------------------------------------------
    for scope in _scopes(items):
        for pos, idx in enumerate(scope):
            ins: Instr = items[idx]
            if ins.tag != "demoted_store" or ins.ctrl.read_bar is None:
                continue
            vreg = ins.srcs[1]
            rewritten = any(
                vreg in items[j].dst_words() for j in scope[pos + 1 :]
            )
            if not rewritten:
                bar = ins.ctrl.read_bar
                ins.ctrl.read_bar = None
                _remove_barrier_waits(items, scope, idx, {bar})
                moved += 1

    # --- demoted load hoisting ----------------------------------------------
    def war_guard_bars(i_pred: int, vreg: int) -> Set[int]:
        """Read barriers unresolved just before position ``i_pred`` that guard
        ``vreg`` (an in-flight store still reads it).  The load must not move
        above an instruction whose wait resolves one of these."""
        pending: Dict[int, int] = {}
        # walk the enclosing scope up to i_pred
        for j in range(i_pred, -1, -1):
            it = items[j]
            if isinstance(it, Label) or (
                isinstance(it, Instr) and (it.info.is_branch or it.info.is_exit)
            ):
                start = j + 1
                break
        else:
            start = 0
        for j in range(start, i_pred):
            x = items[j]
            if not isinstance(x, Instr):
                continue
            for b in x.ctrl.wait:
                for r in [r for r, bb in pending.items() if bb == b]:
                    del pending[r]
            if x.ctrl.read_bar is not None:
                for r in x.src_words():
                    pending[r] = x.ctrl.read_bar
        return {b for r, b in pending.items() if r == vreg}

    def legal_swap(i: int, p: Instr, load: Instr) -> bool:
        if p.info.is_branch or p.info.is_exit:
            return False
        vreg = load.dsts[0]
        if vreg in p.dst_words() or vreg in p.src_words():
            return False
        if load.srcs[0] in p.dst_words():
            return False
        # predicate dependence
        if load.pred is not None and p.pdst == load.pred:
            return False
        # shared-memory aliasing: demoted slots only alias demoted accesses
        # to the same offset; stay conservative around user smem stores
        if p.op == "STS" and (p.tag != "demoted_store" or p.offset == load.offset):
            return False
        if p.tag == "demoted_load" and p.offset == load.offset:
            return False
        # barrier interactions
        p_sets = {b for b in (p.ctrl.write_bar, p.ctrl.read_bar) if b is not None}
        l_sets = {b for b in (load.ctrl.write_bar, load.ctrl.read_bar) if b is not None}
        if p_sets & l_sets:
            return False
        if p_sets & load.ctrl.wait or l_sets & p.ctrl.wait:
            return False
        # WAR guard: p's wait may be what licenses the load to clobber vreg
        if p.ctrl.wait & war_guard_bars(i - 1, vreg):
            return False
        return True

    changed = True
    passes = 0
    while changed and passes < max_hoist:
        changed = False
        passes += 1
        for i in range(1, len(items)):
            ins = items[i]
            if not isinstance(ins, Instr) or ins.tag != "demoted_load":
                continue
            p = items[i - 1]
            if not isinstance(p, Instr):
                continue
            if legal_swap(i, p, ins):
                items[i - 1], items[i] = ins, p
                moved += 1
                changed = True
    fixup_stalls(kernel)
    return moved


# ---------------------------------------------------------------------------
# Pass 3: substituting the value register
# ---------------------------------------------------------------------------


def substitute_value_register(kernel: Kernel, rdv: int, reg_budget: int) -> int:
    """Give distinct demoted-access spans distinct free registers.

    A *span* is the run from a demoted load (or the renamed defining
    instruction) through the matching demoted store / last use.  With one
    RDV only one demoted value can be in flight; substitution widens the
    window so hoisting (pass 2) can overlap several demoted accesses.
    Returns the number of spans renamed.
    """
    live = liveness(kernel)
    from .isa import CFG

    cfg = CFG(kernel)
    renamed = 0
    for blk in cfg.blocks:
        if not blk.instrs:
            continue
        lin, lout = live[blk.index]
        used: Set[int] = set()
        for ins in blk.instrs:
            used |= ins.regs()
        # a temporary must already exist in the program (else resurrecting it
        # would raise the packed register count) but be dead across this block
        program_regs = kernel.used_registers()
        free = [
            f
            for f in sorted(program_regs)
            if f < reg_budget and f not in used and f not in lin and f not in lout and f != RZ
        ]
        if not free:
            continue
        # collect spans: one span per RDV *value lifetime* (from the load or
        # defining instruction through every use, including demoted stores
        # and post-elimination reuses, until the value is replaced)
        spans: List[List[Instr]] = []
        cur: Optional[List[Instr]] = None
        for ins in blk.instrs:
            touches = rdv in ins.leading_regs()
            if not touches:
                if (rdv + 1) in ins.regs() and cur is not None:
                    # odd-alias access (pair traffic): poison the span
                    spans.remove(cur)
                    cur = None
                continue
            if ins.info.width == 2:
                # pair spans keep RDV (substitution would need an aligned
                # free pair); poison any open span for safety
                if cur is not None:
                    spans.remove(cur)
                cur = None
                continue
            replaces_value = (
                ins.tag == "demoted_load" and ins.dsts[0] == rdv
            ) or (
                ins.tag != "demoted_store"
                and rdv in ins.dsts
                and rdv not in ins.srcs
            )
            if replaces_value:
                cur = [ins]
                spans.append(cur)
            elif cur is not None:
                cur.append(ins)
            else:
                # reads RDV with unknown provenance (should not happen: loads
                # are inserted next to uses) — bail out for the whole block
                spans = []
                break
        # leave every other span on RDV; give the rest free registers
        fi = 0
        for si, span in enumerate(spans):
            if si % 2 == 0 or fi >= len(free):
                continue
            f = free[fi]
            fi += 1
            for ins in span:
                ins.rename(rdv, f)
            renamed += 1
    if renamed:
        fixup_stalls(kernel)
    return renamed
