"""Fixed-width machine encoding of abstract-ISA instructions.

Real Maxwell packs one instruction into a 64-bit word and bundles 21 bits of
control per instruction into a preceding 64-bit control word (three
instructions per bundle).  The abstract ISA carries more per-instruction
payload than fits in 64 bits (a full float64 immediate, a 32-bit address
offset, trip-count metadata), so the record here is 24 bytes — but the
*shape* of the text section is kept faithful: groups of one 8-byte control
bundle followed by its three instruction records.

Instruction record layout (little-endian, 24 bytes):

======  ====  ======================================================
offset  size  field
======  ====  ======================================================
0       1     opcode index (into the sorted :data:`OPCODE_IDS` table)
1       1     flags: bit0 has_imm, bit1 has_target, bit2 has_pred,
              bit3 pred_neg, bit4 has_pdst, bit5 has_trip
2       1     pred (low nibble) | pdst (high nibble)
3       1     n_src (bits 0-1) | n_dst (bit 2) | tag index (bits 3-6)
4       4     dst, src0, src1, src2 register numbers (RZ = 255)
8       4     memory offset immediate (unsigned)
12      2     branch-target label index (0xffff = none)
14      2     loop trip count (0xffff = none)
16      8     float64 immediate
======  ====  ======================================================

The encoder is strict: any instruction the record cannot represent exactly
raises :class:`EncodingError` rather than silently truncating — the
round-trip self check (:mod:`repro_torch.binary.roundtrip`) depends on encode
being injective.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.isa import OPCODES, Instr, Label

from .archcodec import MAXWELL_CODEC, RECORD_SIZE as _CODEC_RECORD_SIZE, TextCodec
from .ctrlwords import BUNDLE_GROUP

#: Stable opcode numbering: insertion order of the ISA opcode table.
OPCODE_IDS: Dict[str, int] = {name: i for i, name in enumerate(OPCODES)}
OPCODE_NAMES: List[str] = list(OPCODES)

#: Documented provenance tags (isa.Instr.tag); containers may extend this
#: per kernel for tags introduced by future transformations.
DEFAULT_TAGS: Tuple[str, ...] = (
    "orig",
    "demoted_load",
    "demoted_store",
    "remat",
    "spill_load",
    "spill_store",
)

_REC = struct.Struct("<BBBBBBBBIHHd")
INSTR_RECORD_SIZE = _REC.size  # 24
assert INSTR_RECORD_SIZE == 24 == _CODEC_RECORD_SIZE

#: Bytes of one text-section group: control bundle + three records.
GROUP_SIZE = 8 + BUNDLE_GROUP * INSTR_RECORD_SIZE

_F_IMM = 1 << 0
_F_TARGET = 1 << 1
_F_PRED = 1 << 2
_F_PRED_NEG = 1 << 3
_F_PDST = 1 << 4
_F_TRIP = 1 << 5

_NONE16 = 0xFFFF
_MAX_SRCS = 3
_MAX_TAGS = 16


class EncodingError(ValueError):
    """Raised when an instruction cannot be represented in the record."""


def _check(cond: bool, ins: Instr, what: str) -> None:
    if not cond:
        raise EncodingError(f"{ins.render()}: {what}")


def encode_instr(
    ins: Instr,
    label_index: Mapping[str, int],
    tags: Sequence[str] = DEFAULT_TAGS,
) -> bytes:
    """Encode one instruction into its 24-byte record.

    ``label_index`` maps branch-target label names to label-table indices;
    ``tags`` is the per-kernel tag table the record's tag field indexes.
    """
    opcode = OPCODE_IDS.get(ins.op)
    _check(opcode is not None, ins, f"unknown opcode {ins.op!r}")
    _check(len(ins.dsts) <= 1, ins, f"{len(ins.dsts)} destinations (max 1)")
    _check(len(ins.srcs) <= _MAX_SRCS, ins, f"{len(ins.srcs)} sources (max {_MAX_SRCS})")
    for r in ins.dsts + ins.srcs:
        _check(0 <= r <= 255, ins, f"register R{r} out of range")
    _check(0 <= ins.offset < (1 << 32), ins, f"offset {ins.offset:#x} out of range")

    flags = 0
    if ins.imm is not None:
        flags |= _F_IMM
    target = _NONE16
    if ins.target is not None:
        flags |= _F_TARGET
        if ins.target not in label_index:
            raise EncodingError(f"{ins.render()}: dangling branch target {ins.target!r}")
        target = label_index[ins.target]
        _check(target < _NONE16, ins, "label index out of range")
    pred = 0
    if ins.pred is not None:
        flags |= _F_PRED
        _check(0 <= ins.pred <= 15, ins, f"predicate P{ins.pred} out of range")
        pred = ins.pred
        if ins.pred_neg:
            flags |= _F_PRED_NEG
    pdst = 0
    if ins.pdst is not None:
        flags |= _F_PDST
        _check(0 <= ins.pdst <= 15, ins, f"predicate dst P{ins.pdst} out of range")
        pdst = ins.pdst
    trip = _NONE16
    if ins.trip_count is not None:
        flags |= _F_TRIP
        _check(0 <= ins.trip_count < _NONE16, ins, f"trip count {ins.trip_count} out of range")
        trip = ins.trip_count
    try:
        tag_idx = tags.index(ins.tag)
    except ValueError:
        raise EncodingError(f"{ins.render()}: tag {ins.tag!r} not in tag table {tags}")
    _check(tag_idx < _MAX_TAGS, ins, "tag table overflow")

    shape = len(ins.srcs) | (len(ins.dsts) << 2) | (tag_idx << 3)
    regs = (ins.dsts + [0])[:1] + ins.srcs + [0] * (_MAX_SRCS - len(ins.srcs))
    return _REC.pack(
        opcode,
        flags,
        pred | (pdst << 4),
        shape,
        regs[0],
        regs[1],
        regs[2],
        regs[3],
        ins.offset,
        target,
        trip,
        ins.imm if ins.imm is not None else 0.0,
    )


def decode_instr(
    record: bytes,
    label_names: Sequence[str],
    tags: Sequence[str] = DEFAULT_TAGS,
) -> Instr:
    """Decode one 24-byte record (inverse of :func:`encode_instr`).

    The control word is *not* part of the record; callers overlay it from
    the text section's bundles (see :func:`decode_text`).
    """
    if len(record) != INSTR_RECORD_SIZE:
        raise EncodingError(f"record must be {INSTR_RECORD_SIZE} bytes, got {len(record)}")
    (opcode, flags, predbyte, shape, dst, s0, s1, s2, offset, target, trip, imm) = _REC.unpack(record)
    if opcode >= len(OPCODE_NAMES):
        raise EncodingError(f"bad opcode index {opcode}")
    n_src = shape & 0x3
    n_dst = (shape >> 2) & 0x1
    tag_idx = (shape >> 3) & 0xF
    if tag_idx >= len(tags):
        raise EncodingError(f"bad tag index {tag_idx} for tag table {tags}")
    ins = Instr(op=OPCODE_NAMES[opcode])
    ins.dsts = [dst][:n_dst]
    ins.srcs = [s0, s1, s2][:n_src]
    ins.offset = offset
    ins.tag = tags[tag_idx]
    if flags & _F_IMM:
        ins.imm = imm
    if flags & _F_TARGET:
        if target >= len(label_names):
            raise EncodingError(f"bad label index {target}")
        ins.target = label_names[target]
    if flags & _F_PRED:
        ins.pred = predbyte & 0xF
        ins.pred_neg = bool(flags & _F_PRED_NEG)
    if flags & _F_PDST:
        ins.pdst = predbyte >> 4
    if flags & _F_TRIP:
        ins.trip_count = trip
    return ins


# ---------------------------------------------------------------------------
# Text sections: bundled control words + instruction records
# ---------------------------------------------------------------------------


def collect_tags(items: Sequence[object]) -> List[str]:
    """Per-kernel tag table: documented tags first, then any novel ones."""
    tags = list(DEFAULT_TAGS)
    for it in items:
        if isinstance(it, Instr) and it.tag not in tags:
            tags.append(it.tag)
    if len(tags) > _MAX_TAGS:
        raise EncodingError(f"more than {_MAX_TAGS} distinct instruction tags")
    return tags


def encode_text(
    items: Sequence[object],
    tags: Optional[Sequence[str]] = None,
    codec: Optional[TextCodec] = None,
) -> Tuple[bytes, List[Tuple[str, int]]]:
    """Encode an item stream (instructions + labels) into a text section.

    Returns ``(text_bytes, labels)`` where ``labels`` is the label table:
    ``(name, instruction_index)`` pairs, the index being the position of the
    first instruction *after* the label (``n_instrs`` for trailing labels).
    Labels live in the container's label section, not in the text bytes —
    exactly how a cubin keeps symbols out of ``.text``.

    ``codec`` chooses the architecture's text layout (control-word packing
    and record geometry; default: Maxwell's bundled layout).
    """
    if tags is None:
        tags = collect_tags(items)
    if codec is None:
        codec = MAXWELL_CODEC
    instrs = [it for it in items if isinstance(it, Instr)]
    labels: List[Tuple[str, int]] = []
    pos = 0
    for it in items:
        if isinstance(it, Label):
            labels.append((it.name, pos))
        elif isinstance(it, Instr):
            pos += 1
        else:
            raise EncodingError(f"unencodable item {it!r}")
    label_index = {}
    for i, (name, _) in enumerate(labels):
        label_index.setdefault(name, i)

    records = [encode_instr(ins, label_index, tags) for ins in instrs]
    out = codec.encode_text_section(records, [ins.ctrl for ins in instrs])
    return out, labels


def decode_text(
    data: bytes,
    n_instrs: int,
    labels: Sequence[Tuple[str, int]],
    tags: Sequence[str] = DEFAULT_TAGS,
    codec: Optional[TextCodec] = None,
) -> List[object]:
    """Decode a text section back into the item stream (inverse of
    :func:`encode_text`)."""
    if codec is None:
        codec = MAXWELL_CODEC
    if len(data) != codec.text_size(n_instrs):
        raise EncodingError(
            f"text section is {len(data)} bytes; {n_instrs} instructions "
            f"need {codec.text_size(n_instrs)} ({codec.name} layout)"
        )
    ctrls, records = codec.decode_text_section(data, n_instrs)
    label_names = [name for name, _ in labels]
    instrs: List[Instr] = []
    for i in range(n_instrs):
        ins = decode_instr(records[i], label_names, tags)
        ins.ctrl = ctrls[i]
        instrs.append(ins)

    items: List[object] = []
    by_pos: Dict[int, List[str]] = {}
    for name, pos in labels:
        by_pos.setdefault(pos, []).append(name)
    for i, ins in enumerate(instrs):
        for name in by_pos.get(i, []):
            items.append(Label(name))
        items.append(ins)
    for name in by_pos.get(n_instrs, []):
        items.append(Label(name))
    return items


def instr_addr(index: int, codec: Optional[TextCodec] = None) -> int:
    """Byte offset of instruction ``index`` within its text section
    (Maxwell's bundled layout unless another arch codec is given)."""
    return (codec or MAXWELL_CODEC).instr_addr(index)
