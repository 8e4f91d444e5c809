"""Maxwell control-word packing (SASSOverlay field layout).

On Maxwell/Pascal every instruction carries 21 bits of scheduling control,
and three consecutive instructions share one 64-bit control *bundle* that
precedes them in the text section.  The per-instruction layout, LSB first,
matches the field list SASSOverlay decodes (``[5, 3, 3, 6, 3, 1]``):

====  =====  ====================================================
bits  field  meaning
====  =====  ====================================================
0-3   stall  issue-stall cycles before the next instruction (0-15)
4     yield  *inverted* yield flag: bit set => NO yield
5-7   wbar   write-barrier index signalled on result write (7 = none)
8-10  rbar   read-barrier index signalled on operand read (7 = none)
11-16 wait   6-bit mask over the scoreboard barriers to wait on
17-19 reuse  operand-reuse cache slots (unused by the abstract ISA)
20    pad    reserved, always 0
====  =====  ====================================================

``pack_ctrl``/``unpack_ctrl`` convert :class:`repro_torch.core.isa.Ctrl` to and
from this 21-bit integer; ``pack_bundle``/``unpack_bundle`` gang three of
them into the 64-bit word the container's text sections store.  The packed
form is lossless over every control word :func:`repro_torch.core.sched.schedule`
can produce, which is what makes the container a faithful carrier of the
schedule (golden-byte tests pin the exact layout).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

from repro_torch.core.isa import NUM_BARRIERS, Ctrl

#: Bits of control information per instruction.
CTRL_BITS = 21

#: Instructions covered by one 64-bit control bundle.
BUNDLE_GROUP = 3

#: Barrier-field value meaning "no barrier signalled".
NO_BARRIER = 7

_STALL_MASK = 0xF
_YIELD_BIT = 1 << 4
_WBAR_SHIFT = 5
_RBAR_SHIFT = 8
_WAIT_SHIFT = 11
_WAIT_MASK = (1 << NUM_BARRIERS) - 1
_CTRL_MASK = (1 << CTRL_BITS) - 1

#: Control word of an idle slot (stall 0, no yield, no barriers, no waits) —
#: used to pad the final bundle of a text section.
NOP_CTRL = _YIELD_BIT | (NO_BARRIER << _WBAR_SHIFT) | (NO_BARRIER << _RBAR_SHIFT)


class CtrlWordError(ValueError):
    """Raised when a control word cannot be represented in 21 bits."""


def pack_ctrl(ctrl: Ctrl) -> int:
    """Pack one :class:`Ctrl` into its 21-bit machine form."""
    if not 0 <= ctrl.stall <= _STALL_MASK:
        raise CtrlWordError(f"stall {ctrl.stall} out of range 0..15")
    word = ctrl.stall & _STALL_MASK
    # hardware encodes yield inverted: bit set means "do not yield"
    if not ctrl.yield_flag:
        word |= _YIELD_BIT
    for name, bar, shift in (
        ("write", ctrl.write_bar, _WBAR_SHIFT),
        ("read", ctrl.read_bar, _RBAR_SHIFT),
    ):
        if bar is None:
            word |= NO_BARRIER << shift
        else:
            if not 0 <= bar < NUM_BARRIERS:
                raise CtrlWordError(f"{name} barrier {bar} out of range 0..5")
            word |= bar << shift
    wait = 0
    for b in ctrl.wait:
        if not 0 <= b < NUM_BARRIERS:
            raise CtrlWordError(f"wait barrier {b} out of range 0..5")
        wait |= 1 << b
    word |= wait << _WAIT_SHIFT
    return word


def unpack_ctrl(word: int) -> Ctrl:
    """Decode a 21-bit control word back into a :class:`Ctrl`."""
    if not 0 <= word <= _CTRL_MASK:
        raise CtrlWordError(f"control word {word:#x} wider than {CTRL_BITS} bits")
    wbar = (word >> _WBAR_SHIFT) & 0x7
    rbar = (word >> _RBAR_SHIFT) & 0x7
    wait = (word >> _WAIT_SHIFT) & _WAIT_MASK
    return Ctrl(
        stall=word & _STALL_MASK,
        yield_flag=not (word & _YIELD_BIT),
        write_bar=None if wbar == NO_BARRIER else wbar,
        read_bar=None if rbar == NO_BARRIER else rbar,
        wait={b for b in range(NUM_BARRIERS) if wait & (1 << b)},
    )


def pack_bundle(words: Sequence[int]) -> int:
    """Pack up to three 21-bit control words into one 64-bit bundle.

    Slot 0 occupies the low bits, like the Maxwell control bundle preceding
    its three instructions.  Missing trailing slots are filled with
    :data:`NOP_CTRL`.
    """
    if len(words) > BUNDLE_GROUP:
        raise CtrlWordError(f"bundle holds at most {BUNDLE_GROUP} control words")
    bundle = 0
    for slot in range(BUNDLE_GROUP):
        word = words[slot] if slot < len(words) else NOP_CTRL
        if not 0 <= word <= _CTRL_MASK:
            raise CtrlWordError(f"control word {word:#x} wider than {CTRL_BITS} bits")
        bundle |= word << (slot * CTRL_BITS)
    return bundle


def unpack_bundle(bundle: int, count: int = BUNDLE_GROUP) -> List[int]:
    """Split a 64-bit bundle back into its first ``count`` control words."""
    if not 0 <= bundle < (1 << 64):
        raise CtrlWordError("bundle must be a 64-bit value")
    if not 0 <= count <= BUNDLE_GROUP:
        raise CtrlWordError(f"count must be 0..{BUNDLE_GROUP}")
    return [(bundle >> (slot * CTRL_BITS)) & _CTRL_MASK for slot in range(count)]


def pack_stream(ctrls: Iterable[Ctrl]) -> List[int]:
    """Pack a whole instruction stream's controls into 64-bit bundles."""
    words = [pack_ctrl(c) for c in ctrls]
    return [
        pack_bundle(words[i : i + BUNDLE_GROUP])
        for i in range(0, len(words), BUNDLE_GROUP)
    ]


def unpack_stream(bundles: Sequence[int], n_instrs: int) -> List[Ctrl]:
    """Inverse of :func:`pack_stream` for ``n_instrs`` instructions."""
    need = (n_instrs + BUNDLE_GROUP - 1) // BUNDLE_GROUP
    if len(bundles) < need:
        raise CtrlWordError(
            f"{n_instrs} instructions need {need} bundles, got {len(bundles)}"
        )
    ctrls: List[Ctrl] = []
    for i, bundle in enumerate(bundles[:need]):
        left = n_instrs - i * BUNDLE_GROUP
        for word in unpack_bundle(bundle, min(BUNDLE_GROUP, left)):
            ctrls.append(unpack_ctrl(word))
    return ctrls
