"""Architecture-registry tests: registry behaviour, the Maxwell descriptor's
parity with the historical constants, golden pins for the Volta/Turing codec
layout, and a cross-arch demotion golden against ``BENCH_arch.json``."""

import json
import os
import struct

import pytest

from repro_torch.arch import (
    MAXWELL_ARCH,
    VOLTA_ARCH,
    ArchError,
    arch_names,
    arch_of,
    get_arch,
    retarget,
)
from repro_torch.binary import dumps, loads
from repro_torch.binary.archcodec import MAXWELL_CODEC, VOLTA_CODEC
from repro_torch.binary.container import ContainerError
from repro_torch.binary.ctrlwords import CtrlWordError
from repro_torch.core.occupancy import MAXWELL as LEGACY_MAXWELL_SM
from repro_torch.core.simulator import (
    ISSUE_INTERVAL as LEGACY_ISSUE_INTERVAL,
    ISSUE_WIDTH as LEGACY_ISSUE_WIDTH,
    LOCAL_EFFECTIVE_LATENCY as LEGACY_LOCAL_LATENCY,
)
from repro_torch.core.isa import Ctrl, Instr, Kernel, OpClass, equivalent
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, paper_kernel
from repro_torch.core.occupancy import occupancy
from repro_torch.core.regdem import demote
from repro_torch.core.sched import schedule, verify_schedule
from repro_torch.core.simulator import simulate, simulate_reference

BENCH_ARCH_PATH = os.path.join(os.path.dirname(__file__), "..", "BENCH_arch.json")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_names_and_aliases():
    assert arch_names() == ["maxwell", "volta"]
    assert get_arch("maxwell") is MAXWELL_ARCH
    assert get_arch("volta") is VOLTA_ARCH
    # aliases resolve to the canonical descriptor
    assert get_arch("pascal") is MAXWELL_ARCH
    assert get_arch("sm_52") is MAXWELL_ARCH
    assert get_arch("turing") is VOLTA_ARCH
    assert get_arch("SM_75") is VOLTA_ARCH  # case-insensitive


def test_unknown_arch_rejected():
    with pytest.raises(ArchError, match="unknown architecture"):
        get_arch("ampere")


def test_arch_of_defaults_to_maxwell():
    assert arch_of(Kernel(name="k")) is MAXWELL_ARCH


# ---------------------------------------------------------------------------
# Maxwell descriptor == the historical constants (regression pin)
# ---------------------------------------------------------------------------


def test_maxwell_descriptor_matches_legacy_constants():
    a = MAXWELL_ARCH
    assert a.sm is LEGACY_MAXWELL_SM
    assert a.num_barriers == 6 and a.num_reg_banks == 4 and a.num_smem_banks == 32
    assert a.issue_width == LEGACY_ISSUE_WIDTH
    for k in OpClass:
        assert a.issue_interval(k) == LEGACY_ISSUE_INTERVAL[k]
        assert a.throughput_ratio(k) == 128 / k.throughput
    assert a.latency.global_mem == 200
    assert a.latency.local == LEGACY_LOCAL_LATENCY
    assert a.latency.shared == 24 and a.latency.alu == 6
    assert a.smem_spill_limit == 48 * 1024
    # signal latencies match the simulator's historical table
    assert a.signal_latency(OpClass.LSU_GLOBAL) == 200
    assert a.signal_latency(OpClass.LSU_LOCAL) == 80
    assert a.signal_latency(OpClass.LSU_SHARED) == 24
    assert a.signal_latency(OpClass.FP64) == 48
    assert a.signal_latency(OpClass.SFU) == 20
    assert a.codec is MAXWELL_CODEC


def test_volta_descriptor_headlines():
    a = VOLTA_ARCH
    assert a.dual_issue is False and MAXWELL_ARCH.dual_issue is True
    assert a.num_reg_banks == 2
    assert a.smem_spill_limit == 96 * 1024
    assert a.sm.smem_per_block == 96 * 1024
    assert a.codec is VOLTA_CODEC
    # FP64 is 8x wider than Maxwell: 32 lanes -> one warp per cycle
    assert a.issue_interval(OpClass.FP64) == 1.0
    assert MAXWELL_ARCH.issue_interval(OpClass.FP64) == 8.0


def test_volta_register_banking():
    assert [VOLTA_ARCH.reg_bank(r) for r in range(4)] == [0, 1, 0, 1]
    assert VOLTA_ARCH.rdv_banks(wide=False) == [0, 1]
    # pair demotion pins RDV to the even bank on a 2-bank file
    assert VOLTA_ARCH.rdv_banks(wide=True) == [0]
    assert MAXWELL_ARCH.rdv_banks(wide=True) == [0, 2]
    ins = Instr("FADD", [8], [3, 5])  # banks 1 and 1 on volta; 3 and 1 on maxwell
    assert VOLTA_ARCH.bank_conflicts(ins) == 1
    assert MAXWELL_ARCH.bank_conflicts(ins) == 0


# ---------------------------------------------------------------------------
# golden: the Volta/Turing control-word layout (TuringAs field order)
# ---------------------------------------------------------------------------


def test_golden_volta_ctrl_layout():
    # stall 1, no yield, no barriers, no waits
    assert VOLTA_CODEC.pack_ctrl(Ctrl()) == 0x7E1
    # stall 2, yield, WR0, waits {0,5} — yield is bit 4, NOT inverted
    assert (
        VOLTA_CODEC.pack_ctrl(Ctrl(stall=2, yield_flag=True, write_bar=0, wait={0, 5}))
        == 0x10F12
    )
    # everything maxed: stall 15, WR5, RD3, all six waits
    assert (
        VOLTA_CODEC.pack_ctrl(
            Ctrl(stall=15, write_bar=5, read_bar=3, wait=set(range(6)))
        )
        == 0x1FBAF
    )


def test_volta_yield_not_inverted():
    quiet = Ctrl()  # yield_flag=False
    loud = Ctrl(yield_flag=True)
    # Maxwell sets bit 4 for NO yield; Volta sets it FOR yield
    assert MAXWELL_CODEC.pack_ctrl(quiet) & 0x10
    assert not MAXWELL_CODEC.pack_ctrl(loud) & 0x10
    assert not VOLTA_CODEC.pack_ctrl(quiet) & 0x10
    assert VOLTA_CODEC.pack_ctrl(loud) & 0x10


def test_volta_ctrl_roundtrip_and_range_checks():
    for ctrl in (
        Ctrl(),
        Ctrl(stall=7, yield_flag=True, write_bar=2, read_bar=4, wait={1, 3, 5}),
        Ctrl(stall=0, write_bar=0, read_bar=0, wait=set(range(6))),
    ):
        back = VOLTA_CODEC.unpack_ctrl(VOLTA_CODEC.pack_ctrl(ctrl))
        assert (back.stall, back.yield_flag, back.write_bar, back.read_bar, back.wait) == (
            ctrl.stall, ctrl.yield_flag, ctrl.write_bar, ctrl.read_bar, ctrl.wait
        )
    with pytest.raises(CtrlWordError, match="stall"):
        VOLTA_CODEC.pack_ctrl(Ctrl(stall=16))
    with pytest.raises(CtrlWordError, match="barrier"):
        VOLTA_CODEC.pack_ctrl(Ctrl(write_bar=6))
    with pytest.raises(CtrlWordError, match="wider"):
        VOLTA_CODEC.unpack_ctrl(1 << 21)


def test_golden_volta_in_word_embedding():
    """The control block sits at bits 105..125 of the 128-bit instruction:
    bit 41 of the trailing 8-byte high word, one 32-byte record per
    instruction, no bundles."""
    assert VOLTA_CODEC.instr_size == 32
    assert VOLTA_CODEC.text_size(3) == 96 and VOLTA_CODEC.instr_addr(2) == 64
    # Maxwell geometry for the same three instructions: one 8B bundle + 3x24B
    assert MAXWELL_CODEC.text_size(3) == 80

    rec = bytes(range(24))
    blob = VOLTA_CODEC.encode_text_section([rec], [Ctrl()])
    assert len(blob) == 32
    assert blob[:24] == rec
    # golden: default ctrl 0x7e1 << 41 little-endian
    assert blob[24:] == struct.pack("<Q", 0x7E1 << 41)
    assert blob[24:].hex() == "0000000000c20f00"
    ctrls, records = VOLTA_CODEC.decode_text_section(blob, 1)
    assert records == [rec]
    assert ctrls[0].stall == 1 and ctrls[0].write_bar is None

    # stray bits outside the control field are corruption, not data
    bad = bytearray(blob)
    bad[24] ^= 0x01
    with pytest.raises(CtrlWordError, match="non-control"):
        VOLTA_CODEC.decode_text_section(bytes(bad), 1)


# ---------------------------------------------------------------------------
# retarget + containers
# ---------------------------------------------------------------------------


def test_retarget_produces_schedulable_equivalent_kernel():
    k = paper_kernel("conv")
    kv = retarget(k, "volta")
    assert kv.arch == "volta" and k.arch == "maxwell"  # input untouched
    assert verify_schedule(kv) == []
    assert equivalent(k, kv)
    assert "arch=volta" in kv.render().splitlines()[0]


def test_volta_container_roundtrip_and_mixed_batch():
    k = paper_kernel("md5hash")
    kv = retarget(k, "volta")
    blob = dumps(kv)
    back = loads(blob)
    assert back.arch == "volta"
    assert back.render() == kv.render()
    assert dumps(back) == blob  # byte stability
    # one v3 container can mix architectures
    from repro_torch.binary import loads_many

    mixed = dumps([k, kv])
    a, b = loads_many(mixed)
    assert (a.arch, b.arch) == ("maxwell", "volta")
    assert a.render() == k.render() and b.render() == kv.render()


def test_volta_rejected_by_legacy_container_versions():
    kv = retarget(paper_kernel("md5hash"), "volta")
    for version in (1, 2):
        with pytest.raises(ContainerError, match="v3 required"):
            dumps(kv, version=version)


def test_alias_arch_tag_round_trips_verbatim():
    """An alias tag ("turing") is stored verbatim so the container round
    trip is render- and byte-identity; behaviour still resolves through the
    registry to the same descriptor."""
    kv = retarget(paper_kernel("md5hash"), "turing")
    assert kv.arch == "volta"  # retarget canonicalizes its output
    kv.arch = "turing"  # an alias tag applied directly
    assert arch_of(kv) is VOLTA_ARCH
    blob = dumps(kv)
    back = loads(blob)
    assert back.arch == "turing"
    assert back.render() == kv.render()
    assert dumps(back) == blob
    # the round-trip oracle accepts alias-tagged kernels
    from repro_torch.binary.roundtrip import check_roundtrip

    check_roundtrip(kv, check_semantics=False)


# ---------------------------------------------------------------------------
# cross-arch machine model: occupancy, scheduling, simulation
# ---------------------------------------------------------------------------


def test_volta_shared_memory_carveout():
    # 60 KiB static shared per block: legal on Volta, over Maxwell's limit
    v = occupancy(40, 256, 60 * 1024, sm=VOLTA_ARCH.sm)
    assert v.resident_blocks >= 1
    with pytest.raises(ValueError, match="per-block limit"):
        occupancy(40, 256, 60 * 1024, sm=MAXWELL_ARCH.sm)


def test_volta_schedule_uses_shorter_alu_latency():
    def chain(arch):
        k = Kernel(name="chain", arch=arch, live_in={1}, live_out={4})
        k.items = [
            Instr("FADD", [2], [1, 1]),
            Instr("FADD", [3], [2, 2]),
            Instr("FADD", [4], [3, 3]),
            Instr("EXIT"),
        ]
        schedule(k)
        return [ins.ctrl.stall for ins in k.instructions()]

    m = chain("maxwell")
    v = chain("volta")
    # dependent ALU chain: Maxwell pads to 6 cycles, Volta to 4
    assert m[0] == 6 and v[0] == 4
    assert sum(m) > sum(v)


def test_volta_sim_engine_matches_reference():
    k = retarget(paper_kernel("nn"), "volta")
    fast = simulate(k)
    ref = simulate_reference(k)
    assert fast.total_cycles == ref.total_cycles
    assert fast.issue_stalls == ref.issue_stalls
    assert fast.occupancy.occupancy == ref.occupancy.occupancy


# ---------------------------------------------------------------------------
# golden: cross-arch demotion results pinned against BENCH_arch.json
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench_arch():
    with open(BENCH_ARCH_PATH) as fh:
        return json.load(fh)


def test_bench_arch_covers_all_archs_and_benchmarks(bench_arch):
    assert sorted(bench_arch["archs"]) == ["maxwell", "volta"]
    assert set(bench_arch["table3"]) == set(PAPER_BENCHMARKS)
    for bench, per_arch in bench_arch["table3"].items():
        assert sorted(per_arch) == ["maxwell", "volta"]


@pytest.mark.parametrize("bench", ["conv", "md"])
def test_golden_cross_arch_demotion(bench, bench_arch):
    """Recompute one Table-3-style demotion per arch and pin it against the
    committed BENCH_arch.json (and hard literals, so a stale regeneration
    of the JSON cannot silently shift the baseline)."""
    prof = PAPER_BENCHMARKS[bench]
    base = paper_kernel(bench)
    for arch in ("maxwell", "volta"):
        k = base if arch == "maxwell" else retarget(base, arch)
        res = demote(k, prof.regdem_target, verify="final")
        row = bench_arch["table3"][bench][arch]
        assert res.demoted_words == row["demoted_words"]
        assert res.kernel.reg_count == row["regs_after"]
        assert simulate(res.kernel).total_cycles == row["cycles_regdem"]
        assert simulate(k).total_cycles == row["cycles_nvcc"]
    # hard pins (computed when the golden was made): the demotion count is arch-invariant
    # for these kernels, the *cycles* are not
    assert bench_arch["table3"][bench]["maxwell"]["demoted_words"] == (
        5 if bench == "conv" else 4
    )
    assert (
        bench_arch["table3"][bench]["maxwell"]["cycles_regdem"]
        != bench_arch["table3"][bench]["volta"]["cycles_regdem"]
    )


def test_golden_volta_md_regression_case(bench_arch):
    """The register/shared trade-off shifts across generations: ``md``
    (FP64-bound) gains from demotion on neither arch dramatically, but on
    Volta — with 8x the FP64 throughput — the demotion overhead makes it a
    clear loss.  This is the cross-generation effect the multi-arch backend
    exists to expose; pin the direction."""
    md = bench_arch["table3"]["md"]
    assert md["volta"]["sim_speedup"] < 1.0 < md["maxwell"]["sim_speedup"]
