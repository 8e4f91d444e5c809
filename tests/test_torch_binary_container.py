"""Container-format tests: metadata fidelity, multi-kernel files, and
strictness against corruption."""

import pytest

from repro_torch.binary import container
from repro_torch.binary.container import ContainerError, dumps, kernel_names, loads, loads_many
from repro_torch.binary.encoding import EncodingError, instr_addr
from repro_torch.core.isa import Instr, Kernel, Label
from repro_torch.core.kernelgen import paper_kernel
from repro_torch.core.regdem import auto_targets, demote
from repro_torch.core.sched import schedule


def tiny_kernel(name="tiny") -> Kernel:
    k = Kernel(name=name, live_in={1}, live_out={7}, threads_per_block=64, num_blocks=8)
    k.items = [
        Instr("MOV32I", dsts=[4], imm=2.5),
        Instr("LDG", dsts=[5], srcs=[1], offset=0x40),
        Label("L0"),
        Instr("FADD", dsts=[7], srcs=[4, 5], pred=1, pred_neg=True),
        Instr("ISETP", srcs=[4, 5], pdst=2),
        Instr("BRA", target="L0", pred=2, trip_count=3),
        Instr("EXIT"),
    ]
    return schedule(k)


def test_metadata_round_trip():
    k = tiny_kernel()
    k.shared_size = 512
    k.demoted_size = 256
    k.rda = 9
    k2 = loads(dumps(k))
    assert k2.name == "tiny"
    assert (k2.threads_per_block, k2.num_blocks) == (64, 8)
    assert (k2.shared_size, k2.demoted_size) == (512, 256)
    assert k2.live_in == {1} and k2.live_out == {7}
    assert k2.rda == 9
    assert k2.render() == k.render()


def test_instruction_field_fidelity():
    k2 = loads(dumps(tiny_kernel()))
    mov, ldg, fadd, isetp, bra, exit_ = k2.instructions()
    assert mov.imm == 2.5 and mov.dsts == [4]
    assert ldg.offset == 0x40 and ldg.srcs == [1]
    assert fadd.pred == 1 and fadd.pred_neg is True
    assert isetp.pdst == 2 and isetp.dsts == []
    assert bra.target == "L0" and bra.trip_count == 3 and bra.pred == 2
    assert exit_.op == "EXIT"
    assert isinstance(k2.items[2], Label) and k2.items[2].name == "L0"


def test_demoted_kernel_tags_and_rda_survive():
    k = paper_kernel("conv")
    res = demote(k, auto_targets(k)[0])
    k2 = loads(dumps(res.kernel))
    assert k2.rda == res.kernel.rda
    assert k2.demoted_size == res.kernel.demoted_size
    tags = {i.tag for i in k2.instructions()}
    assert "demoted_load" in tags or "demoted_store" in tags
    assert k2.render() == res.kernel.render()


def test_multi_kernel_container():
    ks = [tiny_kernel("a"), paper_kernel("md"), tiny_kernel("c")]
    blob = dumps(ks)
    assert kernel_names(blob) == ["a", "md", "c"]
    back = loads_many(blob)
    assert [k.name for k in back] == ["a", "md", "c"]
    for orig, dec in zip(ks, back):
        assert dec.render() == orig.render()
    with pytest.raises(ContainerError):
        loads(blob)  # single-kernel accessor refuses multi-kernel files


def test_deterministic_bytes():
    assert dumps(tiny_kernel()) == dumps(tiny_kernel())


def test_bad_magic_rejected():
    blob = bytearray(dumps(tiny_kernel()))
    blob[0] ^= 0xFF
    with pytest.raises(ContainerError, match="magic"):
        loads(bytes(blob))


def test_truncation_rejected():
    blob = dumps(tiny_kernel())
    with pytest.raises(ContainerError):
        loads(blob[: len(blob) - 7])
    with pytest.raises(ContainerError):
        loads(blob[:16])


def test_bitflip_rejected_by_content_crc():
    k = tiny_kernel()
    blob = bytearray(dumps(k))
    text_off = 32 + container.KINFO_SIZE
    blob[text_off + instr_addr(0) + 16] ^= 0xFF  # a bit of the immediate
    with pytest.raises(ContainerError, match="content checksum"):
        loads(bytes(blob))


def test_reg_count_tamper_rejected():
    # flip a register number inside the first instruction record AND forge
    # the content CRC: the declared-vs-recomputed register count check must
    # still catch it.  Uses a v1 container (no per-kernel CRC) so the tamper
    # reaches that deeper line of defense.
    import struct
    import zlib

    k = tiny_kernel()
    blob = bytearray(dumps(k, version=1))
    # first text section starts right after the 32-byte header + kinfo
    text_off = 32 + container.KINFO_SIZES[1]
    dst_off = text_off + instr_addr(0) + 4  # record byte 4 = dst reg
    assert blob[dst_off] == 4  # MOV32I dst is R4
    blob[dst_off] = 200
    struct.pack_into("<I", blob, 28, zlib.crc32(bytes(blob[32:])) & 0xFFFFFFFF)
    with pytest.raises(ContainerError, match="reg count"):
        loads(bytes(blob))


def test_kernel_crc_tamper_rejected_in_v2():
    # same tamper with a forged outer CRC on a v2 container: the per-kernel
    # content CRC is the line of defense that fires
    import struct
    import zlib

    k = tiny_kernel()
    blob = bytearray(dumps(k))
    text_off = 32 + container.KINFO_SIZES[container.VERSION]
    blob[text_off + instr_addr(0) + 4] = 200
    struct.pack_into("<I", blob, 28, zlib.crc32(bytes(blob[32:])) & 0xFFFFFFFF)
    with pytest.raises(ContainerError, match="content CRC"):
        loads(bytes(blob))


def test_v1_container_still_loads():
    """Backward compatibility: v1 single-kernel containers load unchanged."""
    k = tiny_kernel()
    k.shared_size = 512
    k.rda = 9
    v1 = dumps(k, version=1)
    v2 = dumps(k, version=2)
    assert len(v1) == len(v2) - 4  # v2 adds exactly the 4-byte per-kernel CRC
    back = loads(v1)
    assert back.render() == k.render()
    assert back.rda == 9 and back.shared_size == 512
    assert back.arch == "maxwell"  # pre-registry containers default to Maxwell
    assert kernel_names(v1) == ["tiny"]
    # and re-dumping the v1-decoded kernel produces a current (v3) container
    assert loads(dumps(back)).render() == k.render()


def test_v2_multi_kernel_roundtrip_with_crcs():
    """A v2 multi-kernel container round-trips; per-kernel CRCs are stable,
    layout-independent, and equal for identical content."""
    a, b = tiny_kernel("a"), paper_kernel("md")
    blob = dumps([a, b, tiny_kernel("a")])
    back = loads_many(blob)
    assert [k.name for k in back] == ["a", "md", "a"]
    for orig, dec in zip([a, b, a], back):
        assert dec.render() == orig.render()
    # same content -> same CRC; CRC independent of sibling kernels
    assert container.kernel_crc(back[0]) == container.kernel_crc(back[2])
    assert container.kernel_crc(back[0]) == container.kernel_crc(tiny_kernel("a"))
    assert container.kernel_crc(back[0]) != container.kernel_crc(tiny_kernel("c"))


def test_unsupported_version_rejected():
    import struct

    blob = bytearray(dumps(tiny_kernel()))
    struct.pack_into("<H", blob, 8, 99)  # version field follows the 8B magic
    with pytest.raises(ContainerError, match="version"):
        loads(bytes(blob))
    with pytest.raises(ContainerError, match="version"):
        dumps(tiny_kernel(), version=99)


def test_empty_container_rejected():
    with pytest.raises(ContainerError):
        dumps([])


def test_unknown_opcode_version_guard(monkeypatch):
    blob = dumps(tiny_kernel())
    monkeypatch.setattr(container, "opcode_checksum", lambda: 0xDEADBEEF)
    with pytest.raises(ContainerError, match="checksum"):
        loads(blob)


def test_dangling_branch_target_rejected():
    k = Kernel(name="bad")
    k.items = [Instr("BRA", target="nowhere"), Instr("EXIT")]
    with pytest.raises(EncodingError, match="dangling"):
        dumps(k)


def test_oversized_trip_count_rejected():
    k = Kernel(name="bad")
    k.items = [
        Label("L"),
        Instr("BRA", target="L", trip_count=1 << 20),
        Instr("EXIT"),
    ]
    with pytest.raises(EncodingError, match="trip count"):
        dumps(k)
