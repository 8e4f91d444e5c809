"""Binary substrate: a pseudo-cubin assembler/disassembler for the abstract ISA.

The paper's pyReDe tool is a *binary* translator: it extracts SASS from a
``.cubin``, rewrites it, and re-inserts the machine code.  This package gives
the reproduction the same substrate — a fixed-width machine encoding of
:mod:`repro_torch.core.isa` instructions, Maxwell-style bundled control words, and a
minimal cubin-like container — so :func:`repro_torch.core.translator.translate` can
run bytes-in / bytes-out instead of operating on the textual rendering.

Modules
-------

* :mod:`repro_torch.binary.ctrlwords`  21-bit control-word packing (stall, yield,
  read/write barrier, wait mask) and 64-bit 3-instruction bundles
* :mod:`repro_torch.binary.encoding`   fixed-width (24-byte) instruction records
* :mod:`repro_torch.binary.container`  pseudo-cubin container: header, section
  table, string table, per-kernel metadata; ``dumps``/``loads``
* :mod:`repro_torch.binary.overlay`    SASSOverlay-style annotated disassembly
* :mod:`repro_torch.binary.roundtrip`  encode/decode self-checks (dataflow
  equivalence + schedule validity + stable re-render)
"""

from .archcodec import (
    MAXWELL_CODEC,
    VOLTA_CODEC,
    MaxwellCodec,
    TextCodec,
    VoltaCodec,
)
from .container import (
    VERSION,
    ContainerError,
    dumps,
    kernel_crc,
    kernel_names,
    loads,
    loads_many,
    read_notes,
)
from .ctrlwords import (
    CTRL_BITS,
    pack_bundle,
    pack_ctrl,
    unpack_bundle,
    unpack_ctrl,
)
from .encoding import (
    INSTR_RECORD_SIZE,
    EncodingError,
    decode_instr,
    decode_text,
    encode_instr,
    encode_text,
)
from .overlay import format_ctrl_columns, overlay, overlay_lines
from .roundtrip import (
    RoundTripError,
    check_roundtrip,
    roundtrip,
    verified_dumps,
    verified_dumps_many,
)

__all__ = [
    "CTRL_BITS",
    "INSTR_RECORD_SIZE",
    "MAXWELL_CODEC",
    "VOLTA_CODEC",
    "VERSION",
    "ContainerError",
    "EncodingError",
    "MaxwellCodec",
    "RoundTripError",
    "TextCodec",
    "VoltaCodec",
    "check_roundtrip",
    "decode_instr",
    "decode_text",
    "dumps",
    "encode_instr",
    "encode_text",
    "format_ctrl_columns",
    "kernel_crc",
    "kernel_names",
    "loads",
    "loads_many",
    "overlay",
    "overlay_lines",
    "pack_bundle",
    "pack_ctrl",
    "read_notes",
    "roundtrip",
    "unpack_bundle",
    "unpack_ctrl",
    "verified_dumps",
    "verified_dumps_many",
]
