"""Register-compaction tests (paper §3.3, Fig. 4)."""


from repro_torch.core.compaction import compact, packed_reg_count
from repro_torch.core.isa import Instr, Kernel, equivalent
from repro_torch.core.kernelgen import all_paper_kernels
from repro_torch.core.sched import schedule


def _gap_kernel(pairs=False):
    """A kernel using a sparse register set with gaps."""
    k = Kernel(name="gappy", live_in={1}, live_out=set())
    items = [
        Instr("MOV32I", [10], imm=1.0),
        Instr("MOV32I", [20], imm=2.0),
        Instr("FADD", [30], [10, 20]),
    ]
    if pairs:
        items += [
            Instr("MOV32I", [40], imm=3.0),
            Instr("MOV32I", [41], imm=3.5),
            Instr("DADD", [40], [40, 40]),
        ]
    items += [Instr("STG", srcs=[1, 30]), Instr("EXIT")]
    k.items = items
    return schedule(k)


def test_compaction_packs_singles():
    k = _gap_kernel()
    before = k.reg_count
    compact(k)
    assert k.reg_count < before
    assert k.reg_count == packed_reg_count(k)


def test_compaction_preserves_semantics():
    k = _gap_kernel(pairs=True)
    k0 = k.copy()
    compact(k)
    assert equivalent(k0, k)


def test_compaction_keeps_pair_alignment():
    k = _gap_kernel(pairs=True)
    compact(k)
    for ins in k.instructions():
        if ins.info.width == 2:
            for r in ins.dsts + (ins.srcs if not ins.info.is_memory else ins.srcs[1:]):
                assert r % 2 == 0, ins.render()


def test_compaction_pins_abi_registers():
    k = _gap_kernel()
    compact(k)
    # live-in register 1 must still be register 1
    stg = [i for i in k.instructions() if i.op == "STG"][0]
    assert stg.srcs[0] == 1


def test_compaction_never_increases_count():
    for name, k in all_paper_kernels().items():
        before = k.reg_count
        kk = k.copy()
        compact(kk)
        assert kk.reg_count <= before, name
        assert equivalent(k, kk), name


def test_bank_aware_compaction_safe():
    for name, k in all_paper_kernels().items():
        kk = k.copy()
        compact(kk, bank_avoid=True)
        assert equivalent(k, kk), name
        assert kk.reg_count <= k.reg_count


def test_relocation_space_swap_window():
    """Fig. 4(c): a pair blocked by alignment swaps with the window below."""
    k = Kernel(name="swap", live_in=set())
    k.items = [
        Instr("MOV32I", [0], imm=1.0),
        Instr("MOV32I", [3], imm=2.0),  # gap at 1,2 ; single at 3
        Instr("MOV32I", [4], imm=3.0),
        Instr("MOV32I", [5], imm=3.5),
        Instr("DADD", [4], [4, 4]),     # pair at 4-5
        Instr("STG", srcs=[0, 3]),
        Instr("EXIT"),
    ]
    schedule(k)
    k0 = k.copy()
    compact(k)
    assert k.reg_count <= 4  # 0 + single + pair = 4 registers packed
    assert equivalent(k0, k)


def test_packed_reg_count_lower_bound():
    for name, k in all_paper_kernels().items():
        kk = k.copy()
        est = packed_reg_count(kk)
        compact(kk)
        assert kk.reg_count >= est - 1  # estimator is a (near-)tight bound
        assert kk.reg_count <= est + 1
