"""Container back-compat coverage: v1 and v2 byte streams load under the v3
reader, default to the Maxwell arch tag, and re-serialize as valid v3 —
plus the cross-arch container round-trip fuzz the nightly workflow runs
with a larger example budget (``REGDEM_PROPERTY_SCALE``)."""

import os
import struct

import pytest

from repro_torch.binary import container
from repro_torch.binary.container import dumps, loads, loads_many
from repro_torch.core.isa import Instr, Kernel, Label
from repro_torch.core.kernelgen import paper_kernel
from repro_torch.core.sched import schedule


def tiny_kernel(name="tiny") -> Kernel:
    k = Kernel(name=name, live_in={1}, live_out={7}, threads_per_block=64, num_blocks=8)
    k.items = [
        Instr("MOV32I", dsts=[4], imm=2.5),
        Instr("LDG", dsts=[5], srcs=[1], offset=0x40),
        Label("L0"),
        Instr("FADD", dsts=[7], srcs=[4, 5], pred=1, pred_neg=True),
        Instr("BRA", target="L0", pred=1, trip_count=3),
        Instr("EXIT"),
    ]
    return schedule(k)


def _header_version(blob: bytes) -> int:
    return struct.unpack_from("<H", blob, 8)[0]  # version follows the 8B magic


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_versions_load_under_v3_reader(version):
    k = tiny_kernel()
    k.shared_size = 256
    legacy = dumps(k, version=version)
    assert _header_version(legacy) == version

    back = loads(legacy)
    # pre-registry containers default to the Maxwell arch tag
    assert back.arch == "maxwell"
    assert back.render() == k.render()
    assert back.shared_size == 256

    # ... and re-serialize as a valid, loadable v3 container
    upgraded = dumps(back)
    assert _header_version(upgraded) == 3
    assert container.VERSION == 3
    again = loads(upgraded)
    assert again.arch == "maxwell"
    assert again.render() == k.render()
    # the v3 re-serialization is stable
    assert dumps(again) == upgraded


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_multi_kernel_upgrade(version):
    ks = [tiny_kernel("a"), tiny_kernel("b"), tiny_kernel("a")]
    legacy = dumps(ks, version=version)
    back = loads_many(legacy)
    assert [k.arch for k in back] == ["maxwell"] * 3
    upgraded = dumps(back)
    assert _header_version(upgraded) == 3
    assert [k.render() for k in loads_many(upgraded)] == [k.render() for k in ks]


def test_v2_and_v3_store_identical_maxwell_crcs():
    """The per-kernel content CRC of a Maxwell kernel is version-invariant,
    so translation-cache keys survive the v3 upgrade."""
    k = tiny_kernel()
    v2 = loads(dumps(k, version=2))
    v3 = loads(dumps(k, version=3))
    assert v2.content_crc == v3.content_crc == container.kernel_crc(k)


def test_v3_kinfo_grows_by_arch_field():
    sizes = container.KINFO_SIZES
    assert sizes[2] == sizes[1] + 4  # content CRC
    assert sizes[3] == sizes[2] + 4  # arch strtab offset
    assert container.KINFO_SIZE == sizes[3]


def test_v3_unknown_arch_name_rejected():
    """A v3 container naming an unregistered arch fails loudly (with a
    forged CRC so the arch check itself is what fires)."""
    k = tiny_kernel()
    blob = bytearray(dumps(k))
    # grow a fake strtab entry is intrusive; instead point the arch offset
    # at the kernel-name string ("tiny"), which is not a registered arch.
    # kinfo is the first section after the 32-byte header; the arch offset
    # is the last 4 bytes of the single kinfo record.
    arch_off_pos = 32 + container.KINFO_SIZE - 4
    name_off = struct.unpack_from("<I", blob, 32)[0]  # kinfo field 0
    struct.pack_into("<I", blob, arch_off_pos, name_off)
    import zlib

    struct.pack_into("<I", blob, 28, zlib.crc32(bytes(blob[32:])) & 0xFFFFFFFF)
    with pytest.raises(container.ContainerError, match="unknown architecture"):
        loads(bytes(blob))


# ---------------------------------------------------------------------------
# cross-arch round-trip fuzz (nightly runs this with a larger budget)
# ---------------------------------------------------------------------------

pytest.importorskip("hypothesis", reason="fuzz tests need hypothesis")

from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

from repro_torch.arch import arch_names, retarget  # noqa: E402
from repro_torch.core.kernelgen import generate, random_profile  # noqa: E402

SCALE = max(1, int(os.environ.get("REGDEM_PROPERTY_SCALE", "1")))


@given(
    seed=st.integers(min_value=0, max_value=10_000),
    arch=st.sampled_from(sorted(arch_names())),
)
@settings(
    max_examples=10 * SCALE,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)
def test_fuzz_cross_arch_container_roundtrip(seed, arch):
    """encode -> decode -> re-encode is byte-identity on every arch, and the
    decoded kernel re-renders identically (the round-trip oracle, fuzzed
    across both architectures)."""
    k = generate(random_profile(seed % 200))
    if arch != "maxwell":
        k = retarget(k, arch)
    blob = dumps(k)
    back = loads(blob)
    assert back.arch == arch
    assert back.render() == k.render()
    assert dumps(back) == blob


@given(seed=st.integers(min_value=0, max_value=10_000))
@settings(
    max_examples=5 * SCALE,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)
def test_fuzz_mixed_arch_batch_roundtrip(seed):
    """Multi-kernel containers mixing arches round-trip byte-stably."""
    base = generate(random_profile(seed % 200))
    batch = [base] + [retarget(base, a) for a in sorted(arch_names()) if a != "maxwell"]
    blob = dumps(batch)
    back = loads_many(blob)
    assert [k.arch for k in back] == [k.arch for k in batch]
    assert dumps(back) == blob


def test_demoted_paper_kernel_upgrade_path():
    """A realistic v2 artifact (demoted kernel with spill tags) upgrades to
    v3 with content intact."""
    from repro_torch.core.regdem import auto_targets, demote

    k = paper_kernel("conv")
    res = demote(k, auto_targets(k)[0])
    legacy = dumps(res.kernel, version=2)
    back = loads(legacy)
    assert back.arch == "maxwell"
    upgraded = dumps(back)
    assert _header_version(upgraded) == 3
    assert loads(upgraded).render() == res.kernel.render()
