"""Pseudo-cubin container: serialize kernels as self-describing binaries.

A real ``.cubin`` is an ELF: header, section table, ``.strtab``, one
``.text.<kernel>`` section per kernel plus ``.nv.info`` metadata (register
count, shared-memory size, parameters).  This container mirrors that shape
at the smallest size that still exercises every pyReDe pipeline step:

========================  ==================================================
region                    contents
========================  ==================================================
header (32 B)             magic, version, section count/offset, kernel
                          count, opcode-table checksum, content checksum
``.kinfo``                one fixed 168-byte record per kernel: name, launch
                          geometry, shared/demoted bytes, declared register
                          count, RDA register, live-in/out bitmasks, tag
                          table
``.text.<kernel>``        bundled control words + instruction records
                          (:mod:`repro_torch.binary.encoding`)
``.labels.<kernel>``      label table: (strtab name, instruction index)
``.strtab``               null-terminated strings (kernel/label/tag names)
section table (16 B/row)  (name, kind, offset, size) per section, ELF-style
                          with a null section at index 0
========================  ==================================================

``dumps``/``loads`` are strict: every structural invariant (magic, version,
opcode-table checksum, section bounds, declared vs. recomputed register
count) is checked on load, so a corrupted or stale container fails loudly
instead of producing a subtly wrong kernel.

Format v2 extends the v1 ``.kinfo`` record with a **per-kernel content
CRC** — :func:`kernel_crc` over the kernel's name, launch metadata,
tag/label tables, and text bytes.  It is the integrity check for each kernel
of a multi-kernel container and the key of the translation cache
(:class:`repro_torch.core.translator.TranslationCache`): two kernels with equal
CRCs translate to byte-identical output, so repeated kernels skip the pass
pipeline entirely.

Format v3 (current) adds a **per-kernel architecture tag** — a strtab
offset naming the :mod:`repro_torch.arch` registry entry the kernel is encoded
for.  The arch determines the text-section codec (Maxwell's bundled
control words vs Volta/Turing's in-word control fields) and everything
downstream (scheduler latencies, occupancy limits, spill budget).  v1 and
v2 containers still load unchanged and default to the ``maxwell`` arch;
writing v1/v2 is only possible for Maxwell kernels (older readers cannot
represent any other arch).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.isa import OPCODES, Kernel

from . import encoding

MAGIC = b"RDEMCBN\x01"
VERSION = 3
SUPPORTED_VERSIONS = (1, 2, 3)

#: Section kinds (the ``kind`` column of the section table).
SEC_NULL, SEC_STRTAB, SEC_KINFO, SEC_TEXT, SEC_LABELS, SEC_NOTE = range(6)

_HDR = struct.Struct("<8sHHIHHIII")  # magic, version, n_sections, shoff,
#                                      strtab index, n_kernels, opcode crc,
#                                      file size, content crc
_HDR_PAD = 32 - _HDR.size
_SEC = struct.Struct("<IIII")  # name_off, kind, offset, size
_LBL = struct.Struct("<II")  # name_off, instr_idx
_KINFO_V1 = struct.Struct("<IIIHHIIIIIHH16I32s32s")
_KINFO_V2 = struct.Struct("<IIIHHIIIIIHH16I32s32sI")  # v1 + per-kernel CRC
_KINFO_V3 = struct.Struct("<IIIHHIIIIIHH16I32s32sII")  # v2 + arch name off
_KINFO_BY_VERSION = {1: _KINFO_V1, 2: _KINFO_V2, 3: _KINFO_V3}
KINFO_SIZES = {v: s.size for v, s in _KINFO_BY_VERSION.items()}
KINFO_SIZE = KINFO_SIZES[VERSION]
_NONE16 = 0xFFFF
_MAX_TAGS = 16


class ContainerError(ValueError):
    """Raised on malformed, corrupted, or incompatible container bytes."""


def _get_arch(name: str):
    """Resolve an arch descriptor, mapping unknown names to ContainerError.

    Lazy import: :mod:`repro_torch.arch` pulls in the codec modules of this
    package, so the registry is resolved at call time, not import time.
    """
    from repro_torch.arch import ArchError, get_arch

    try:
        return get_arch(name)
    except ArchError as exc:
        raise ContainerError(str(exc)) from None


def opcode_checksum() -> int:
    """CRC of the ISA opcode table — guards against decoding a container
    produced under a different opcode numbering."""
    return zlib.crc32(",".join(OPCODES).encode()) & 0xFFFFFFFF


def _content_crc(
    name: str,
    threads: int,
    blocks: int,
    shared: int,
    demoted: int,
    reg_count: int,
    rda_enc: int,
    live_in_mask: bytes,
    live_out_mask: bytes,
    tags: Sequence[str],
    labels: Sequence[Tuple[str, int]],
    text: bytes,
    arch: str = "maxwell",
) -> int:
    """The per-kernel content CRC over everything translation can observe.

    Computed from *resolved* strings (never strtab offsets), so the value is
    independent of section layout, sibling kernels, and container version —
    which is what makes it usable as the translation-cache key.  The arch
    tag is mixed in only off-default so that Maxwell CRCs stay identical to
    their historical v2 values (cache keys survive the v3 upgrade)."""
    h = zlib.crc32(name.encode("utf-8"))
    if arch != "maxwell":
        h = zlib.crc32(b"arch:" + arch.encode("utf-8") + b"\x00", h)
    h = zlib.crc32(
        struct.pack("<IIIIIH", threads, blocks, shared, demoted, reg_count, rda_enc), h
    )
    h = zlib.crc32(live_in_mask, h)
    h = zlib.crc32(live_out_mask, h)
    h = zlib.crc32("\x00".join(tags).encode("utf-8"), h)
    for lbl_name, pos in labels:
        h = zlib.crc32(lbl_name.encode("utf-8") + struct.pack("<I", pos), h)
    h = zlib.crc32(text, h)
    return h & 0xFFFFFFFF


def kernel_crc(kernel: Kernel) -> int:
    """Content CRC of one kernel — what a v2+ container stores in ``.kinfo``
    and what keys the translation cache.  Equal CRCs mean the binary
    translator produces byte-identical output."""
    arch = getattr(kernel, "arch", "maxwell")
    codec = _get_arch(arch).codec
    tags = encoding.collect_tags(kernel.items)
    text, labels = encoding.encode_text(kernel.items, tags, codec=codec)
    return _content_crc(
        kernel.name,
        kernel.threads_per_block,
        kernel.num_blocks,
        kernel.shared_size,
        kernel.demoted_size,
        kernel.reg_count,
        _NONE16 if kernel.rda is None else kernel.rda,
        _regmask(kernel.live_in),
        _regmask(kernel.live_out),
        tags,
        labels,
        text,
        arch,
    )


def _regmask(regs: Iterable[int]) -> bytes:
    mask = 0
    for r in regs:
        if not 0 <= r <= 255:
            raise ContainerError(f"register R{r} out of bitmask range")
        mask |= 1 << r
    return mask.to_bytes(32, "little")


def _unmask(mask: bytes) -> set:
    value = int.from_bytes(mask, "little")
    return {r for r in range(256) if value & (1 << r)}


class _StrTab:
    """Deduplicating null-terminated string table (offset 0 = empty)."""

    def __init__(self) -> None:
        self.blob = bytearray(b"\x00")
        self.offsets: Dict[str, int] = {"": 0}

    def add(self, s: str) -> int:
        if s not in self.offsets:
            self.offsets[s] = len(self.blob)
            self.blob += s.encode("utf-8") + b"\x00"
        return self.offsets[s]

    @staticmethod
    def read(blob: bytes, off: int) -> str:
        if off >= len(blob):
            raise ContainerError(f"string offset {off} past strtab end")
        end = blob.find(b"\x00", off)
        if end == -1:
            raise ContainerError(f"unterminated string at strtab offset {off}")
        try:
            return blob[off:end].decode("utf-8")
        except UnicodeDecodeError as exc:
            raise ContainerError(
                f"corrupt string at strtab offset {off}: {exc}"
            ) from None


def dumps(
    kernels: Union[Kernel, Iterable[Kernel]],
    version: int = VERSION,
    notes: Optional[Dict[str, bytes]] = None,
) -> bytes:
    """Serialize one kernel (or an iterable of kernels) to container bytes.

    ``version`` selects the container format (v3 default; v1/v2 write the
    legacy records — no arch tag, v1 also no per-kernel CRC — for interop
    tests, and can only represent Maxwell kernels).

    ``notes`` attaches opaque metadata blobs as ``.note.<name>`` sections
    (ELF ``.note``-style), emitted in sorted name order for byte-stable
    output.  Notes ride outside the kernel records: they never affect a
    kernel's content CRC or decoding (every reader skips unknown section
    kinds), but the container-level content checksum covers them.  The
    translation service stores each tuned kernel's search report this way;
    :func:`read_notes` retrieves them."""
    if version not in SUPPORTED_VERSIONS:
        raise ContainerError(f"cannot write container version {version}")
    klist = [kernels] if isinstance(kernels, Kernel) else list(kernels)
    if not klist:
        raise ContainerError("cannot serialize an empty kernel list")

    strtab = _StrTab()
    # section rows accumulate as (name, kind, payload); offsets assigned below
    sections: List[Tuple[str, int, bytes]] = [("", SEC_NULL, b"")]
    kinfo_records: List[bytes] = []

    for kernel in klist:
        # the tag is stored VERBATIM (aliases like "turing" included) so the
        # decoded kernel round-trips render- and byte-identically; behaviour
        # always resolves through the registry, which knows the aliases
        arch_name = getattr(kernel, "arch", "maxwell")
        arch = _get_arch(arch_name)
        if version < 3 and arch_name != "maxwell":
            # pre-v3 containers have no arch field: a legacy reader would
            # load this kernel as literal "maxwell", silently dropping the
            # tag (and, for v2, invalidating the stored CRC) — so even
            # maxwell *aliases* like "pascal" require v3
            raise ContainerError(
                f"kernel {kernel.name}: container version {version} cannot "
                f"represent arch {arch_name!r} (v3 required)"
            )
        codec = arch.codec
        tags = encoding.collect_tags(kernel.items)
        text, labels = encoding.encode_text(kernel.items, tags, codec=codec)
        text_sec = len(sections) + 1  # +1: .kinfo is inserted at index 1
        sections.append((f".text.{kernel.name}", SEC_TEXT, text))
        lbl_blob = b"".join(
            _LBL.pack(strtab.add(name), pos) for name, pos in labels
        )
        sections.append((f".labels.{kernel.name}", SEC_LABELS, lbl_blob))

        tag_offs = [strtab.add(t) for t in tags] + [0] * (_MAX_TAGS - len(tags))
        rda_enc = _NONE16 if kernel.rda is None else kernel.rda
        live_in_mask = _regmask(kernel.live_in)
        live_out_mask = _regmask(kernel.live_out)
        fields = (
            strtab.add(kernel.name),
            len(kernel.instructions()),
            len(labels),
            text_sec,
            text_sec + 1,
            kernel.threads_per_block,
            kernel.num_blocks,
            kernel.shared_size,
            kernel.demoted_size,
            kernel.reg_count,
            rda_enc,
            len(tags),
            *tag_offs,
            live_in_mask,
            live_out_mask,
        )
        if version >= 2:
            crc = _content_crc(
                kernel.name,
                kernel.threads_per_block,
                kernel.num_blocks,
                kernel.shared_size,
                kernel.demoted_size,
                kernel.reg_count,
                rda_enc,
                live_in_mask,
                live_out_mask,
                tags,
                labels,
                text,
                arch_name,
            )
            fields = fields + (crc,)
        if version >= 3:
            fields = fields + (strtab.add(arch_name),)
        kinfo_records.append(_KINFO_BY_VERSION[version].pack(*fields))

    for note_name in sorted(notes or {}):
        payload = notes[note_name]
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            raise ContainerError(f"note {note_name!r}: payload must be bytes")
        sections.append((f".note.{note_name}", SEC_NOTE, bytes(payload)))

    sections.insert(1, (".kinfo", SEC_KINFO, b"".join(kinfo_records)))
    sections.append((".strtab", SEC_STRTAB, b""))  # payload patched below
    strtab_index = len(sections) - 1

    # resolve section names through the strtab *before* freezing its payload
    name_offs = [strtab.add(name) for name, _, _ in sections]
    sections[strtab_index] = (".strtab", SEC_STRTAB, bytes(strtab.blob))

    offset = 32  # header
    rows: List[bytes] = []
    payload = bytearray()
    for (name, kind, data), name_off in zip(sections, name_offs):
        rows.append(_SEC.pack(name_off, kind, offset if data else 0, len(data)))
        payload += data
        offset += len(data)
    shoff = offset
    total = shoff + len(rows) * _SEC.size

    body = bytes(payload) + b"".join(rows)
    header = _HDR.pack(
        MAGIC,
        version,
        len(sections),
        shoff,
        strtab_index,
        len(klist),
        opcode_checksum(),
        total,
        zlib.crc32(body) & 0xFFFFFFFF,
    ) + b"\x00" * _HDR_PAD
    return header + body


def _parse_sections(data: bytes) -> Tuple[List[Tuple[str, int, bytes]], int, int]:
    """Validate the envelope and return ``[(name, kind, payload)]``, the
    kernel count, and the container version."""
    if len(data) < 32:
        raise ContainerError("container truncated before header")
    (magic, version, n_sections, shoff, strtab_index, n_kernels, opc_crc, total,
     content_crc) = _HDR.unpack(data[: _HDR.size])
    if magic != MAGIC:
        raise ContainerError(f"bad magic {magic!r}")
    if version not in SUPPORTED_VERSIONS:
        raise ContainerError(f"unsupported container version {version}")
    if opc_crc != opcode_checksum():
        raise ContainerError(
            "opcode-table checksum mismatch: container was produced under a "
            "different ISA opcode numbering"
        )
    if total != len(data):
        raise ContainerError(f"container size mismatch: header says {total}, got {len(data)}")
    if zlib.crc32(data[32:]) & 0xFFFFFFFF != content_crc:
        raise ContainerError("content checksum mismatch: container is corrupted")
    if shoff + n_sections * _SEC.size > len(data):
        raise ContainerError("section table out of bounds")
    raw_rows = [
        _SEC.unpack_from(data, shoff + i * _SEC.size) for i in range(n_sections)
    ]
    if not 0 <= strtab_index < n_sections or raw_rows[strtab_index][1] != SEC_STRTAB:
        raise ContainerError("bad strtab section index")
    for name_off, kind, offset, size in raw_rows:
        if size and not 32 <= offset <= len(data) - size:
            raise ContainerError("section payload out of bounds")
    s_off, s_size = raw_rows[strtab_index][2], raw_rows[strtab_index][3]
    strtab = data[s_off : s_off + s_size]
    out = []
    for name_off, kind, offset, size in raw_rows:
        out.append((_StrTab.read(strtab, name_off), kind, data[offset : offset + size]))
    return out, n_kernels, version


def loads_many(data: bytes) -> List[Kernel]:
    """Deserialize every kernel in the container (any supported version)."""
    sections, n_kernels, version = _parse_sections(data)
    kinfo_struct = _KINFO_BY_VERSION[version]
    kinfo_size = kinfo_struct.size
    strtab = next(payload for _, kind, payload in sections if kind == SEC_STRTAB)
    kinfo = next((payload for _, kind, payload in sections if kind == SEC_KINFO), None)
    if kinfo is None:
        raise ContainerError("container has no .kinfo section")
    if len(kinfo) != n_kernels * kinfo_size:
        raise ContainerError(
            f".kinfo holds {len(kinfo)} bytes, expected {n_kernels * kinfo_size}"
        )

    kernels: List[Kernel] = []
    for i in range(n_kernels):
        rec = kinfo_struct.unpack_from(kinfo, i * kinfo_size)
        (name_off, n_instrs, n_labels, text_sec, labels_sec,
         threads, blocks, shared, demoted, reg_count, rda, n_tags) = rec[:12]
        tag_offs = rec[12:28]
        live_in_mask, live_out_mask = rec[28], rec[29]
        stored_crc = rec[30] if version >= 2 else None
        # pre-v3 containers predate the arch registry: always Maxwell.  The
        # stored tag (possibly an alias) is preserved verbatim on the kernel
        # so dump/load/dump is byte-identity; the descriptor resolves it.
        arch_name = _StrTab.read(strtab, rec[31]) if version >= 3 else "maxwell"
        arch = _get_arch(arch_name)
        if not 0 < n_tags <= _MAX_TAGS:
            raise ContainerError(f"bad tag-table size {n_tags}")
        tags = [_StrTab.read(strtab, off) for off in tag_offs[:n_tags]]
        if not 0 <= text_sec < len(sections) or sections[text_sec][1] != SEC_TEXT:
            raise ContainerError(f"kernel {i}: bad text section index {text_sec}")
        if not 0 <= labels_sec < len(sections) or sections[labels_sec][1] != SEC_LABELS:
            raise ContainerError(f"kernel {i}: bad label section index {labels_sec}")
        lbl_blob = sections[labels_sec][2]
        if len(lbl_blob) != n_labels * _LBL.size:
            raise ContainerError(f"kernel {i}: label table size mismatch")
        labels = []
        for j in range(n_labels):
            noff, pos = _LBL.unpack_from(lbl_blob, j * _LBL.size)
            if pos > n_instrs:
                raise ContainerError(f"kernel {i}: label position {pos} past end")
            labels.append((_StrTab.read(strtab, noff), pos))

        name = _StrTab.read(strtab, name_off)
        if stored_crc is not None:
            # per-kernel integrity, checked on the raw section bytes *before*
            # any decoding work is spent on a corrupt kernel
            recomputed = _content_crc(
                name, threads, blocks, shared, demoted, reg_count, rda,
                live_in_mask, live_out_mask, tags, labels, sections[text_sec][2],
                arch_name,
            )
            if recomputed != stored_crc:
                raise ContainerError(
                    f"kernel {name}: per-kernel content CRC mismatch "
                    f"(stored {stored_crc:#010x}, recomputed {recomputed:#010x})"
                )

        # decode failures on corrupt-but-checksum-consistent bytes (or v1
        # containers, which have no per-kernel CRC) must surface as the
        # container's own error type, never a raw struct/IndexError
        # traceback from deep inside the codec
        try:
            items = encoding.decode_text(
                sections[text_sec][2], n_instrs, labels, tags, codec=arch.codec
            )
        except ContainerError:
            raise
        except (encoding.EncodingError, struct.error, IndexError, KeyError,
                ValueError, UnicodeDecodeError) as exc:
            raise ContainerError(
                f"kernel {name}: corrupt text section: {exc}"
            ) from None
        kernel = Kernel(
            name=name,
            items=items,
            threads_per_block=threads,
            num_blocks=blocks,
            shared_size=shared,
            demoted_size=demoted,
            live_in=_unmask(live_in_mask),
            live_out=_unmask(live_out_mask),
            rda=None if rda == _NONE16 else rda,
            arch=arch_name,
        )
        if kernel.reg_count != reg_count:
            raise ContainerError(
                f"kernel {kernel.name}: declared reg count {reg_count} != "
                f"recomputed {kernel.reg_count}"
            )
        if stored_crc is not None:
            # hand the verified CRC to consumers (the translation cache keys
            # on it) so they need not re-encode the kernel to recompute it
            kernel.content_crc = stored_crc
        kernels.append(kernel)
    return kernels


def loads(data: bytes) -> Kernel:
    """Deserialize a single-kernel container."""
    kernels = loads_many(data)
    if len(kernels) != 1:
        raise ContainerError(
            f"expected a single-kernel container, found {len(kernels)} "
            "(use loads_many)"
        )
    return kernels[0]


def read_notes(data: bytes) -> Dict[str, bytes]:
    """Metadata blobs attached with ``dumps(..., notes=...)``, keyed by note
    name (the section name minus its ``.note.`` prefix)."""
    sections, _, _ = _parse_sections(data)
    notes: Dict[str, bytes] = {}
    for name, kind, payload in sections:
        if kind == SEC_NOTE:
            notes[name[len(".note."):]] = payload
    return notes


def kernel_names(data: bytes) -> List[str]:
    """Kernel names in the container, without decoding any text section."""
    sections, n_kernels, version = _parse_sections(data)
    size = KINFO_SIZES[version]
    strtab = next(payload for _, kind, payload in sections if kind == SEC_STRTAB)
    kinfo = next((payload for _, kind, payload in sections if kind == SEC_KINFO), None)
    if kinfo is None or len(kinfo) != n_kernels * size:
        raise ContainerError("malformed .kinfo section")
    kinfo_struct = _KINFO_BY_VERSION[version]
    return [
        _StrTab.read(strtab, kinfo_struct.unpack_from(kinfo, i * size)[0])
        for i in range(n_kernels)
    ]
