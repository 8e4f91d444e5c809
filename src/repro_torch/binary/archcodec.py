"""Per-architecture text-section codecs.

The container's ``.text.<kernel>`` sections carry two things per
instruction: the 24-byte instruction record (:mod:`repro_torch.binary.encoding`)
and the scheduling control word.  *Where* the control bits live is an
architecture property, and it is the most visible encoding difference
between the two GPU generations this repo models:

* **Maxwell/Pascal** (:class:`MaxwellCodec`) — 21 bits of control per
  instruction, three instructions sharing one 64-bit control *bundle* that
  precedes them (the SASSOverlay layout of :mod:`repro_torch.binary.ctrlwords`).
  Text-section shape: ``[8-byte bundle][3 x 24-byte records]`` groups, the
  trailing group zero-padded.

* **Volta/Turing** (:class:`VoltaCodec`) — TuringAs-style 128-bit
  instructions with *in-word* control fields: every instruction is
  self-contained, no bundling.  The real encoding parks the control block
  at bits 105..125 of the 128-bit word; the abstract record mirrors that
  with a trailing 8-byte "high word" whose bits 41..61 (= 105-64 .. 125-64)
  hold the control field.  Text-section shape: one 32-byte record per
  instruction (``[24-byte record][8-byte high word]``).

  The Volta field order matches TuringAs: stall 0-3, yield bit 4 (set =
  MAY yield — *not* inverted, unlike Maxwell), write barrier 5-7, read
  barrier 8-10, wait mask 11-16, operand-reuse 17-20 (4 bits, always 0
  here).

Codec instances are owned by :class:`repro_torch.arch.Arch` descriptors;
:mod:`repro_torch.binary.encoding` and :mod:`repro_torch.binary.container` resolve the
codec from the kernel's arch tag.  The Maxwell codec is byte-identical to
the historical (pre-registry) layout — golden tests pin both layouts.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

from repro_torch.core.isa import Ctrl

from .ctrlwords import (
    BUNDLE_GROUP,
    CTRL_BITS,
    CtrlWordError,
    NO_BARRIER,
    pack_ctrl,
    unpack_ctrl,
)

#: Bytes of one instruction record.  :mod:`repro_torch.binary.encoding` imports
#: this module (not the other way around), derives its own size from the
#: struct layout, and asserts the two agree.
RECORD_SIZE = 24


class TextCodec:
    """Arch-specific packing of (records, control words) into text bytes."""

    #: registry name of the owning architecture
    name: str = "abstract"
    #: bits of control information per instruction
    ctrl_bits: int = 0

    def pack_ctrl(self, ctrl: Ctrl) -> int:
        raise NotImplementedError

    def unpack_ctrl(self, word: int) -> Ctrl:
        raise NotImplementedError

    def text_size(self, n_instrs: int) -> int:
        """Exact byte size of a text section holding ``n_instrs``."""
        raise NotImplementedError

    def instr_addr(self, index: int) -> int:
        """Byte offset of instruction ``index`` within its text section."""
        raise NotImplementedError

    def encode_text_section(
        self, records: Sequence[bytes], ctrls: Sequence[Ctrl]
    ) -> bytes:
        raise NotImplementedError

    def decode_text_section(
        self, data: bytes, n_instrs: int
    ) -> Tuple[List[Ctrl], List[bytes]]:
        """Inverse of :meth:`encode_text_section`: ``(ctrls, records)``."""
        raise NotImplementedError


class MaxwellCodec(TextCodec):
    """Maxwell/Pascal: 21-bit control words bundled 3-per-64-bit."""

    name = "maxwell"
    ctrl_bits = CTRL_BITS
    bundle_group = BUNDLE_GROUP
    #: bytes of one text-section group: control bundle + three records
    group_size = 8 + BUNDLE_GROUP * RECORD_SIZE

    def pack_ctrl(self, ctrl: Ctrl) -> int:
        return pack_ctrl(ctrl)

    def unpack_ctrl(self, word: int) -> Ctrl:
        return unpack_ctrl(word)

    def text_size(self, n_instrs: int) -> int:
        n_groups = (n_instrs + BUNDLE_GROUP - 1) // BUNDLE_GROUP
        return n_groups * self.group_size

    def instr_addr(self, index: int) -> int:
        g, slot = divmod(index, BUNDLE_GROUP)
        return g * self.group_size + 8 + slot * RECORD_SIZE

    def encode_text_section(
        self, records: Sequence[bytes], ctrls: Sequence[Ctrl]
    ) -> bytes:
        from .ctrlwords import pack_stream

        bundles = pack_stream(ctrls)
        out = bytearray()
        for g, bundle in enumerate(bundles):
            out += struct.pack("<Q", bundle)
            group = records[g * BUNDLE_GROUP : (g + 1) * BUNDLE_GROUP]
            for rec in group:
                out += rec
            # pad the trailing group so every group is group_size bytes
            out += b"\x00" * ((BUNDLE_GROUP - len(group)) * RECORD_SIZE)
        return bytes(out)

    def decode_text_section(
        self, data: bytes, n_instrs: int
    ) -> Tuple[List[Ctrl], List[bytes]]:
        from .ctrlwords import unpack_stream

        n_groups = (n_instrs + BUNDLE_GROUP - 1) // BUNDLE_GROUP
        bundles = [
            struct.unpack_from("<Q", data, g * self.group_size)[0]
            for g in range(n_groups)
        ]
        ctrls = unpack_stream(bundles, n_instrs)
        records: List[bytes] = []
        for i in range(n_instrs):
            off = self.instr_addr(i)
            records.append(data[off : off + RECORD_SIZE])
        return ctrls, records


# ---------------------------------------------------------------------------
# Volta/Turing: in-word control fields (TuringAs layout)
# ---------------------------------------------------------------------------

#: Bit position of the control block within the 128-bit instruction word
#: (TuringAs packs ``ctrl << 105`` into the high bits).
VOLTA_CTRL_BIT_OFFSET = 105

#: The control block's shift within the trailing 8-byte high word.
_HI_SHIFT = VOLTA_CTRL_BIT_OFFSET - 64  # 41

_STALL_MASK = 0xF
_YIELD_BIT = 1 << 4
_WBAR_SHIFT = 5
_RBAR_SHIFT = 8
_WAIT_SHIFT = 11
_REUSE_BITS = 4  # Volta grows the reuse field to 4 bits (unused here)
_VOLTA_CTRL_BITS = 21
_VOLTA_CTRL_MASK = (1 << _VOLTA_CTRL_BITS) - 1


class VoltaCodec(TextCodec):
    """Volta/Turing: 128-bit instructions, control in-word at bit 105.

    Abstract record: ``[24-byte instruction record][8-byte high word]``;
    the high word carries ``pack_ctrl(ctrl) << 41`` (mirroring bits
    105..125 of the real 128-bit instruction).  No bundling, no padding.
    """

    name = "volta"
    ctrl_bits = _VOLTA_CTRL_BITS
    #: bytes per instruction (the abstract stand-in for 128-bit + payload)
    instr_size = RECORD_SIZE + 8

    def __init__(self, num_barriers: int = 6):
        self.num_barriers = num_barriers
        self._wait_mask = (1 << num_barriers) - 1

    def pack_ctrl(self, ctrl: Ctrl) -> int:
        if not 0 <= ctrl.stall <= _STALL_MASK:
            raise CtrlWordError(f"stall {ctrl.stall} out of range 0..15")
        word = ctrl.stall & _STALL_MASK
        # Volta encodes yield directly: bit set means the warp MAY yield
        if ctrl.yield_flag:
            word |= _YIELD_BIT
        for what, bar, shift in (
            ("write", ctrl.write_bar, _WBAR_SHIFT),
            ("read", ctrl.read_bar, _RBAR_SHIFT),
        ):
            if bar is None:
                word |= NO_BARRIER << shift
            else:
                if not 0 <= bar < self.num_barriers:
                    raise CtrlWordError(
                        f"{what} barrier {bar} out of range 0..{self.num_barriers - 1}"
                    )
                word |= bar << shift
        wait = 0
        for b in ctrl.wait:
            if not 0 <= b < self.num_barriers:
                raise CtrlWordError(
                    f"wait barrier {b} out of range 0..{self.num_barriers - 1}"
                )
            wait |= 1 << b
        word |= wait << _WAIT_SHIFT
        return word

    def unpack_ctrl(self, word: int) -> Ctrl:
        if not 0 <= word <= _VOLTA_CTRL_MASK:
            raise CtrlWordError(
                f"control word {word:#x} wider than {_VOLTA_CTRL_BITS} bits"
            )
        wbar = (word >> _WBAR_SHIFT) & 0x7
        rbar = (word >> _RBAR_SHIFT) & 0x7
        wait = (word >> _WAIT_SHIFT) & self._wait_mask
        return Ctrl(
            stall=word & _STALL_MASK,
            yield_flag=bool(word & _YIELD_BIT),
            write_bar=None if wbar == NO_BARRIER else wbar,
            read_bar=None if rbar == NO_BARRIER else rbar,
            wait={b for b in range(self.num_barriers) if wait & (1 << b)},
        )

    def text_size(self, n_instrs: int) -> int:
        return n_instrs * self.instr_size

    def instr_addr(self, index: int) -> int:
        return index * self.instr_size

    def encode_text_section(
        self, records: Sequence[bytes], ctrls: Sequence[Ctrl]
    ) -> bytes:
        if len(records) != len(ctrls):
            raise CtrlWordError(
                f"{len(records)} records for {len(ctrls)} control words"
            )
        out = bytearray()
        for rec, ctrl in zip(records, ctrls):
            out += rec
            out += struct.pack("<Q", self.pack_ctrl(ctrl) << _HI_SHIFT)
        return bytes(out)

    def decode_text_section(
        self, data: bytes, n_instrs: int
    ) -> Tuple[List[Ctrl], List[bytes]]:
        ctrls: List[Ctrl] = []
        records: List[bytes] = []
        for i in range(n_instrs):
            off = i * self.instr_size
            records.append(data[off : off + RECORD_SIZE])
            (hi,) = struct.unpack_from("<Q", data, off + RECORD_SIZE)
            if hi & ~(_VOLTA_CTRL_MASK << _HI_SHIFT):
                raise CtrlWordError(
                    f"instruction {i}: non-control bits set in the high word"
                )
            ctrls.append(self.unpack_ctrl(hi >> _HI_SHIFT))
        return ctrls, records


#: Shared codec instances (codecs are stateless; arches reference these).
MAXWELL_CODEC = MaxwellCodec()
VOLTA_CODEC = VoltaCodec()
