"""Corrupt / truncated container bytes must raise a clean ``ContainerError``.

Regression suite for the loader's failure taxonomy across every supported
format version: whatever bytes arrive — truncated, bit-flipped, garbled
section tables, stale per-kernel CRCs — ``loads``/``loads_many`` either
return verified kernels or raise :class:`ContainerError` with a diagnosable
message.  Never a raw ``struct.error``/``IndexError`` traceback from deep
inside the codec, and never silently wrong kernels.
"""

import zlib

import pytest

from repro_torch.binary import container
from repro_torch.binary.container import ContainerError, dumps, loads
from repro_torch.core.kernelgen import paper_kernel

VERSIONS = container.SUPPORTED_VERSIONS


def _blob(version):
    return dumps(paper_kernel("md5hash"), version=version)


def _refix_outer_crc(data: bytes) -> bytes:
    """Recompute the envelope checksum after deliberate inner corruption, so
    the test reaches the *inner* validation layers (section table, kinfo,
    per-kernel CRC, text decode) instead of stopping at the envelope."""
    fields = list(container._HDR.unpack(data[: container._HDR.size]))
    fields[-1] = zlib.crc32(data[32:]) & 0xFFFFFFFF
    return (
        container._HDR.pack(*fields)
        + b"\x00" * container._HDR_PAD
        + data[32:]
    )


def _section_span(data: bytes, kind) -> tuple:
    """(offset, size) of the first section of ``kind`` straight from the
    on-disk section table."""
    (_, _, n_sections, shoff, *_rest) = container._HDR.unpack(
        data[: container._HDR.size]
    )
    for i in range(n_sections):
        _, k, off, size = container._SEC.unpack_from(
            data, shoff + i * container._SEC.size
        )
        if k == kind and size:
            return off, size
    raise AssertionError(f"no section of kind {kind}")


@pytest.mark.parametrize("version", VERSIONS)
def test_truncated_header(version):
    data = _blob(version)
    for n in (0, 1, 16, 31):
        with pytest.raises(ContainerError):
            loads(data[:n])


@pytest.mark.parametrize("version", VERSIONS)
def test_truncated_body(version):
    data = _blob(version)
    with pytest.raises(ContainerError, match="size mismatch"):
        loads(data[:-7])


@pytest.mark.parametrize("version", VERSIONS)
def test_bad_magic(version):
    data = _blob(version)
    with pytest.raises(ContainerError, match="magic"):
        loads(b"XXXXXXXX" + data[8:])


@pytest.mark.parametrize("version", VERSIONS)
def test_envelope_checksum_catches_any_flip(version):
    """Without re-fixing the outer CRC, any body corruption is caught at
    the envelope."""
    data = _blob(version)
    for pos in (40, len(data) // 2, len(data) - 3):
        raw = bytearray(data)
        raw[pos] ^= 0x10
        with pytest.raises(ContainerError):
            loads(bytes(raw))


@pytest.mark.parametrize("version", VERSIONS)
def test_bad_section_table(version):
    """A garbled section table (checksum-consistent) is a clean error."""
    data = _blob(version)
    (_, _, n_sections, shoff, *_rest) = container._HDR.unpack(
        data[: container._HDR.size]
    )
    raw = bytearray(data)
    # point the second section's offset out of bounds
    row = shoff + container._SEC.size
    _, kind, _, size = container._SEC.unpack_from(raw, row)
    container._SEC.pack_into(raw, row, 0xFFFFFF, kind, 0xFFFFFFF0, size)
    with pytest.raises(ContainerError):
        loads(_refix_outer_crc(bytes(raw)))


@pytest.mark.parametrize("version", (2, 3))
def test_stale_kernel_crc(version):
    """v2+: a text-section flip behind a re-fixed envelope still fails the
    per-kernel content CRC — corruption is attributed to the kernel."""
    data = _blob(version)
    off, size = _section_span(data, container.SEC_TEXT)
    raw = bytearray(data)
    raw[off + size // 2] ^= 0x01
    with pytest.raises(ContainerError, match="content CRC mismatch"):
        loads(_refix_outer_crc(bytes(raw)))


def test_v1_corrupt_strtab_is_clean_error():
    """v1 has no per-kernel CRC; corruption that defeats the envelope must
    still surface as ContainerError, not a codec traceback."""
    data = _blob(1)
    off, size = _section_span(data, container.SEC_STRTAB)
    raw = bytearray(data)
    raw[off : off + size] = b"\xff" * size  # invalid UTF-8 everywhere
    with pytest.raises(ContainerError):
        loads(_refix_outer_crc(bytes(raw)))


@pytest.mark.parametrize("version", VERSIONS)
def test_corrupt_kinfo_is_clean_error(version):
    data = _blob(version)
    off, size = _section_span(data, container.SEC_KINFO)
    raw = bytearray(data)
    raw[off : off + size] = bytes((b ^ 0xA5) for b in raw[off : off + size])
    with pytest.raises(ContainerError):
        loads(_refix_outer_crc(bytes(raw)))


@pytest.mark.parametrize("version", (2, 3))
def test_random_flips_never_return_wrong_kernels(version):
    """Sweep single-bit flips across the whole container (with the envelope
    re-fixed, so inner layers do the work): every outcome is either a clean
    ContainerError or a kernel identical to the original — never silently
    different code.  This is the per-kernel CRC's guarantee, so it holds
    for v2+ only (v1 predates it — see the test below)."""
    data = _blob(version)
    original = loads(data).render()
    step = max(1, len(data) // 64)
    for pos in range(32, len(data), step):
        raw = bytearray(data)
        raw[pos] ^= 0x04
        try:
            k = loads(_refix_outer_crc(bytes(raw)))
        except ContainerError:
            continue
        # flips in dead padding / unread bytes may decode; they must decode
        # to the same kernel
        assert k.render() == original


def test_v1_random_flips_fail_cleanly_or_decode():
    """v1 cannot detect every checksum-consistent flip (no per-kernel CRC —
    the reason v2 grew one), but it must never leak a raw codec traceback:
    each flip either decodes or raises ContainerError."""
    data = _blob(1)
    step = max(1, len(data) // 64)
    for pos in range(32, len(data), step):
        raw = bytearray(data)
        raw[pos] ^= 0x04
        try:
            loads(_refix_outer_crc(bytes(raw)))
        except ContainerError:
            continue
