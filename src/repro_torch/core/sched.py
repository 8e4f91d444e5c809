"""Control-word scheduling for the abstract ISA.

Two entry points:

* :func:`schedule` — assigns a full Maxwell-style control word (stall,
  write/read barriers, wait masks) to a freshly generated instruction
  stream.  This plays the role of nvcc/ptxas's scheduler and produces the
  "efficient nvcc-generated binary" RegDem starts from (paper §1).

* :func:`fixup_stalls` — after a binary transformation inserted or removed
  instructions, recompute the *stall counts only*, leaving barrier
  assignments untouched (RegDem manages barriers itself through the barrier
  tracker; the paper notes "register allocation and instruction scheduling
  are interacting compiler passes, [so] our optimization considers the
  effect on the instruction schedule and performs updates where needed").

The scheduler's output travels in *machine form*: :func:`export_ctrl_words`
packs every instruction's control into the 21-bit Maxwell layout of
:mod:`repro_torch.binary.ctrlwords` (what the container's text sections store) and
:func:`import_ctrl_words` applies packed words back onto an instruction
stream, so schedules survive the binary->binary pipeline losslessly.

Scheduling model (per basic block, matching the simulator):

* A fixed-latency producer (FP32/INT ALU, 6 cycles) must be separated from
  its consumer by >= latency cycles; the separation is the sum of stall
  counts of the instructions in between (plus theirs own issue cycle).
* Variable-latency producers (memory, FP64, SFU) signal a write barrier;
  consumers carry the barrier index in their wait mask.  Stores additionally
  signal a read barrier to release their source operands.
* Barriers do not survive branches: they are always resolved before the end
  of a basic block (paper §3.2 key observation).
"""

from __future__ import annotations

from typing import Dict, List, Set

from .isa import NUM_BARRIERS, RZ, Ctrl, Instr, Kernel, Label

#: Fixed producer->consumer latency for pipelined (non-barrier) ops
#: (Maxwell; per-arch values come from the :mod:`repro_torch.arch` registry).
ALU_LATENCY = 6
#: Issue cost of a branch/exit.
CTRL_STALL = 5
MAX_STALL = 15


def _arch_of(kernel: Kernel):
    """The kernel's :class:`repro_torch.arch.Arch` (lazy import: repro_torch.arch pulls
    in the binary codecs, which must not load at repro_torch.core import time)."""
    from repro_torch.arch import arch_of

    return arch_of(kernel)


def _blocks(kernel: Kernel) -> List[List[Instr]]:
    """Instruction runs delimited by labels/branches (barrier scopes)."""
    out: List[List[Instr]] = []
    cur: List[Instr] = []
    for it in kernel.items:
        if isinstance(it, Label):
            if cur:
                out.append(cur)
            cur = []
            continue
        cur.append(it)
        if it.info.is_branch or it.info.is_exit:
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    return out


def schedule(kernel: Kernel) -> Kernel:
    """Assign control words in-place; returns the kernel for chaining.

    The machine model (barrier count, fixed latencies) comes from the
    kernel's architecture via the :mod:`repro_torch.arch` registry."""
    arch = _arch_of(kernel)
    for block in _blocks(kernel):
        _schedule_block(block, arch)
    return kernel


def _schedule_block(block: List[Instr], arch=None) -> None:
    if arch is None:
        from repro_torch.arch import get_arch

        arch = get_arch("maxwell")
    num_barriers = arch.num_barriers
    # barrier bookkeeping: barrier index -> producing instr position
    barrier_of_reg: Dict[int, int] = {}   # reg word -> barrier idx guarding it
    barrier_busy: List[bool] = [False] * num_barriers
    read_guard: Dict[int, int] = {}       # reg word -> read barrier of a store
    ready_at: Dict[int, int] = {}         # reg word -> cycle value is ready
    now = 0

    def alloc_barrier(ins: Instr) -> int:
        for b in range(num_barriers):
            if not barrier_busy[b]:
                barrier_busy[b] = True
                return b
        # all six barriers busy: resolve the lowest-numbered one on this
        # instruction first (this is what ptxas emits: a forced wait), then
        # reuse it.  Mirrors the paper's "if the barrier ... was already
        # occupied by a different instruction, additional stalls are
        # introduced".
        b = min(
            set(barrier_of_reg.values()) | set(read_guard.values()) | {0}
        )
        ins.ctrl.wait.add(b)
        for r in [r for r, bb in barrier_of_reg.items() if bb == b]:
            del barrier_of_reg[r]
        for r in [r for r, bb in read_guard.items() if bb == b]:
            del read_guard[r]
        barrier_busy[b] = True
        return b

    for idx, ins in enumerate(block):
        ins.ctrl = Ctrl()
        # 1. wait on barriers guarding our source (and overwritten) operands
        waits: Set[int] = set()
        for r in ins.src_words():
            if r in barrier_of_reg:
                waits.add(barrier_of_reg.pop(r))
        for r in ins.dst_words():
            if r in barrier_of_reg:  # WAW with in-flight load
                waits.add(barrier_of_reg.pop(r))
            if r in read_guard:  # WAR with in-flight store operand
                waits.add(read_guard.pop(r))
        ins.ctrl.wait = waits
        for b in waits:
            barrier_busy[b] = False
            # a barrier resolution releases every register it guarded
            for r in [r for r, bb in barrier_of_reg.items() if bb == b]:
                del barrier_of_reg[r]
            for r in [r for r, bb in read_guard.items() if bb == b]:
                del read_guard[r]

        # 2. fixed-latency RAW separation via stall accumulation
        need = now
        for r in ins.src_words():
            need = max(need, ready_at.get(r, 0))
        if need > now and idx > 0:
            gap = need - now
            # push the gap into preceding stall counts (bounded per instr)
            j = idx - 1
            while gap > 0 and j >= 0:
                add = min(gap, MAX_STALL - block[j].ctrl.stall)
                block[j].ctrl.stall += add
                gap -= add
                j -= 1
            now = need

        # 3. issue
        info = ins.info
        if info.needs_write_barrier:
            b = alloc_barrier(ins)
            ins.ctrl.write_bar = b
            for r in ins.dst_words():
                barrier_of_reg[r] = b
        elif ins.dst_words():
            for r in ins.dst_words():
                ready_at[r] = now + arch.fixed_latency(info.klass)
        if info.needs_read_barrier:
            b = alloc_barrier(ins)
            ins.ctrl.read_bar = b
            for r in ins.src_words():
                if r != RZ:
                    read_guard[r] = b
        ins.ctrl.stall = CTRL_STALL if (info.is_branch or info.is_exit) else 1
        now += ins.ctrl.stall

    # close the block: final branch/exit (or last instr) must drain barriers
    if block:
        last = block[-1]
        pend = set(barrier_of_reg.values()) | set(read_guard.values())
        pend |= {b for b in range(num_barriers) if barrier_busy[b]}
        last.ctrl.wait |= pend


def export_ctrl_words(kernel: Kernel) -> List[int]:
    """The kernel's schedule as packed control words, one per instruction
    in stream order (machine form of :func:`schedule`'s output), in the
    kernel's architecture layout."""
    codec = _arch_of(kernel).codec
    return [codec.pack_ctrl(ins.ctrl) for ins in kernel.instructions()]


def import_ctrl_words(kernel: Kernel, words: List[int]) -> Kernel:
    """Apply packed control words (in the kernel's architecture layout)
    onto the kernel's instructions in-place (inverse of
    :func:`export_ctrl_words`); returns the kernel."""
    codec = _arch_of(kernel).codec
    instrs = kernel.instructions()
    if len(words) != len(instrs):
        raise ValueError(
            f"{kernel.name}: {len(words)} control words for {len(instrs)} instructions"
        )
    for ins, word in zip(instrs, words):
        ins.ctrl = codec.unpack_ctrl(word)
    return kernel


def verify_ctrl_words(kernel: Kernel, words: List[int]) -> List[str]:
    """Validate a packed control-word stream against a kernel's instruction
    stream without mutating it: the words are applied to a copy and checked
    with :func:`verify_schedule`."""
    return verify_schedule(import_ctrl_words(kernel.copy(), words))


def fixup_stalls(kernel: Kernel) -> Kernel:
    """Recompute stall counts after a transformation, keeping barriers.

    Walks each barrier scope, recomputing the fixed-latency RAW gaps the same
    way :func:`_schedule_block` does, but honours the (possibly transformed)
    barrier assignments already present on the instructions.
    """
    arch = _arch_of(kernel)
    for block in _blocks(kernel):
        ready_at: Dict[int, int] = {}
        now = 0
        for idx, ins in enumerate(block):
            # reset stall to the base issue cost, preserving barrier fields
            base = CTRL_STALL if (ins.info.is_branch or ins.info.is_exit) else 1
            ins.ctrl.stall = base
            need = now
            barrier_guarded = _barrier_guarded_regs(block, idx)
            for r in ins.src_words():
                if r not in barrier_guarded:
                    need = max(need, ready_at.get(r, 0))
            if need > now and idx > 0:
                gap = need - now
                j = idx - 1
                while gap > 0 and j >= 0:
                    add = min(gap, MAX_STALL - block[j].ctrl.stall)
                    block[j].ctrl.stall += add
                    gap -= add
                    j -= 1
                now = need
            if ins.dst_words() and not ins.info.needs_write_barrier:
                lat = arch.fixed_latency(ins.info.klass)
                for r in ins.dst_words():
                    ready_at[r] = now + lat
            now += ins.ctrl.stall
    return kernel


def _barrier_guarded_regs(block: List[Instr], upto: int) -> Set[int]:
    """Registers whose readiness is enforced by a barrier wait at ``upto``."""
    guarded: Set[int] = set()
    waits = block[upto].ctrl.wait
    if not waits:
        return guarded
    for prev in block[:upto]:
        if prev.ctrl.write_bar in waits:
            guarded |= set(prev.dst_words())
    return guarded


def repair_war(kernel: Kernel) -> int:
    """Insert missing WAR waits: any instruction overwriting a register that
    an in-flight store still reads (unresolved read barrier) must wait on
    that barrier.  Used after transformations that insert new writers (e.g.
    rematerialization in the comparison variants).  Returns #waits added."""
    added = 0
    for block in _blocks(kernel):
        pending: Dict[int, int] = {}
        for ins in block:
            for b in ins.ctrl.wait:
                for r in [r for r, bb in pending.items() if bb == b]:
                    del pending[r]
            for r in ins.dst_words():
                if r in pending:
                    ins.ctrl.wait.add(pending.pop(r))
                    added += 1
            if ins.ctrl.read_bar is not None:
                for r in ins.src_words():
                    if r != RZ:
                        pending[r] = ins.ctrl.read_bar
    return added


def verify_block(block: List[Instr], num_barriers: int = NUM_BARRIERS) -> List[str]:
    """Schedule validation of ONE barrier scope (see :func:`verify_schedule`).

    Barriers never span scopes, so scopes verify independently — this is what
    lets the pass pipeline re-verify only the scopes a pass touched.
    """
    errors: List[str] = []
    pending_write: Dict[int, int] = {}  # reg -> barrier
    pending_read: Dict[int, int] = {}
    for ins in block:
        for b in ins.ctrl.wait:
            if not 0 <= b < num_barriers:
                errors.append(f"{ins.render()}: wait on bad barrier {b}")
            pending_write = {r: bb for r, bb in pending_write.items() if bb != b}
            pending_read = {r: bb for r, bb in pending_read.items() if bb != b}
        for r in ins.src_words():
            if r in pending_write:
                errors.append(
                    f"{ins.render()}: reads R{r} guarded by unresolved "
                    f"barrier {pending_write[r]}"
                )
        for r in ins.dst_words():
            if r in pending_write:
                errors.append(
                    f"{ins.render()}: WAW on R{r} with unresolved "
                    f"barrier {pending_write[r]}"
                )
            if r in pending_read:
                errors.append(
                    f"{ins.render()}: WAR on R{r} with unresolved read "
                    f"barrier {pending_read[r]}"
                )
        if ins.ctrl.write_bar is not None:
            for r in ins.dst_words():
                pending_write[r] = ins.ctrl.write_bar
        if ins.ctrl.read_bar is not None:
            for r in ins.src_words():
                if r != RZ:
                    pending_read[r] = ins.ctrl.read_bar
    return errors


def verify_schedule(kernel: Kernel) -> List[str]:
    """Static schedule validation; returns a list of violations (empty = ok).

    Checks, per barrier scope:
      * every consumer of a barrier-producing instruction waits on (or is
        issued after something that waited on) its write barrier;
      * store read-barriers protect their operands against overwrite;
      * barrier indices are within range.
    Used by tests and by the translator's self-check.
    """
    errors: List[str] = []
    num_barriers = _arch_of(kernel).num_barriers
    for block in _blocks(kernel):
        errors.extend(verify_block(block, num_barriers))
    return errors
