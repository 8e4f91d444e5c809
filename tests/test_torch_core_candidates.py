"""Candidate-selection tests (paper §3.4.3): every strategy on every arch,
plus the conflict-pruning and register-width edge cases the autotuning
search leans on."""

import pytest

from repro_torch.arch import retarget
from repro_torch.core.candidates import (
    STRATEGIES,
    make_candidates,
    operand_conflicts,
    spillable,
    width_map,
)
from repro_torch.core.isa import RZ, Instr, Kernel
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, paper_kernel
from repro_torch.core.regdem import RegDemOptions, demote
from repro_torch.core.sched import schedule

ARCHS = ("maxwell", "volta")


def _kernel(name="cfd", arch="maxwell"):
    k = paper_kernel(name)
    return k if arch == "maxwell" else retarget(k, arch)


# ---------------------------------------------------------------------------
# every strategy x every arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_basic_contract(strategy, arch):
    """Candidates are unique leading registers with their widths, none of
    them excluded (ABI, RZ, RDA, odd halves of pairs)."""
    k = _kernel("cfd", arch)
    cands = make_candidates(k, strategy)
    assert cands, "cfd must have demotable registers"
    widths = width_map(k)
    regs = [r for r, _ in cands]
    assert len(regs) == len(set(regs))
    excluded = set(k.live_in) | set(k.live_out) | {RZ}
    for r, w in cands:
        assert r not in excluded
        assert w == widths[r]
    # retargeting changes scheduling, not the candidate pool
    assert set(regs) == set(spillable(k))


@pytest.mark.parametrize("arch", ARCHS)
def test_strategy_pool_is_arch_invariant(arch):
    """The same program retargeted must expose the same candidate pool per
    strategy (ordering may legally shift with the schedule)."""
    base = paper_kernel("qtc")
    k = _kernel("qtc", arch)
    for strategy in STRATEGIES:
        assert {r for r, _ in make_candidates(k, strategy)} == {
            r for r, _ in make_candidates(base, strategy)
        }


def test_static_strategy_orders_by_static_counts():
    k = paper_kernel("nn")
    counts = k.static_access_counts()
    cands = make_candidates(k, "static")
    costs = [counts.get(r, 0) for r, _ in cands]
    assert costs == sorted(costs)


def test_conflict_strategy_orders_by_conflict_degree():
    k = paper_kernel("nn")
    conf = operand_conflicts(k)
    cands = make_candidates(k, "conflict")
    degrees = [len(conf.get(r, ())) for r, _ in cands]
    assert degrees == sorted(degrees)


def test_cfg_strategy_weights_loop_bodies():
    """A register touched once inside the loop must rank above (cheaper
    than) it would with static counting x10 — i.e. cfg ordering differs
    from static exactly through the loop weight."""
    k = Kernel(name="loopy", live_in={0, 1}, num_blocks=64, threads_per_block=64)
    from repro_torch.core.isa import Label

    k.items = [
        # r10 used 3x outside the loop, r11 once inside
        Instr("MOV32I", [10], imm=1.0),
        Instr("FADD", [10], [10, 10]),
        Instr("FADD", [10], [10, 10]),
        Instr("MOV32I", [11], imm=2.0),
        Instr("MOV32I", [3], imm=0.0),
        Instr("MOV32I", [4], imm=4.0),
        Label("LOOP"),
        Instr("FADD", [11], [11, 11]),
        Instr("IADD", [3], [3], imm=1.0),
        Instr("ISETP", srcs=[3, 4], pdst=1),
        Instr("BRA", target="LOOP", pred=1, trip_count=4),
        Instr("STG", srcs=[1, 10]),
        Instr("STG", srcs=[1, 11], offset=4),
        Instr("EXIT"),
    ]
    schedule(k)
    static_order = [r for r, _ in make_candidates(k, "static")]
    cfg_order = [r for r, _ in make_candidates(k, "cfg")]
    # statically r11 (2 accesses) is cheaper than r10 (4); with the x10
    # loop weight r11 becomes the expensive one
    assert static_order.index(11) < static_order.index(10)
    assert cfg_order.index(10) < cfg_order.index(11)


def test_unknown_strategy_rejected():
    with pytest.raises(ValueError, match="unknown strategy"):
        make_candidates(paper_kernel("conv"), "greedy")


# ---------------------------------------------------------------------------
# edge case: all candidates mutually conflicting
# ---------------------------------------------------------------------------


def _padded_kernel(name, live_pad, payload, live_out=frozenset()):
    """A kernel whose register pressure sits above REG_FLOOR (32, below
    which demotion never triggers) through *read* live-in padding registers
    — ABI registers count toward the packed register pressure but are
    excluded from candidacy, so only ``payload``'s registers are demotable.
    """
    acc = 2
    k = Kernel(name=name, live_in={0, 1} | set(live_pad),
               live_out={acc} | set(live_out),
               num_blocks=64, threads_per_block=64)
    k.items = [Instr("MOV32I", [acc], imm=0.0)]
    k.items += [Instr("FADD", [acc], [acc, r]) for r in sorted(live_pad)]
    k.items += payload
    k.items += [Instr("STG", srcs=[1, acc], offset=0x40), Instr("EXIT")]
    return schedule(k)


def _all_conflicting_kernel():
    """Three demotable registers that co-occur in every instruction that
    touches them: demoting any one prunes the other two (§3.1 challenge 2)."""
    return _padded_kernel("clash", range(20, 56), [
        Instr("MOV32I", [10], imm=1.0),
        Instr("MOV32I", [11], imm=2.0),
        Instr("MOV32I", [12], imm=3.0),
        Instr("FFMA", [10], [10, 11, 12]),
        Instr("FFMA", [11], [11, 12, 10]),
        Instr("FFMA", [12], [12, 10, 11]),
        Instr("STG", srcs=[1, 10]),
        Instr("STG", srcs=[1, 11], offset=4),
        Instr("STG", srcs=[1, 12], offset=8),
    ])


def test_operand_conflicts_fully_connected():
    conf = operand_conflicts(_all_conflicting_kernel())
    for r in (10, 11, 12):
        assert conf[r] >= {10, 11, 12} - {r}


def test_demote_prunes_conflicting_candidates():
    """With a fully conflicting pool, demotion moves exactly one register
    and stops — the others are pruned, not corrupted."""
    k = _all_conflicting_kernel()
    res = demote(k, 32, RegDemOptions(candidate_strategy="conflict"))
    assert len(res.demoted) == 1
    from repro_torch.core.isa import equivalent

    assert equivalent(k, res.kernel)
    assert not res.reached_target  # pruning stopped it short of the target


# ---------------------------------------------------------------------------
# edge case: zero spillable registers
# ---------------------------------------------------------------------------


def _abi_only_kernel():
    k = Kernel(name="abionly", live_in={0, 1}, live_out={2},
               num_blocks=64, threads_per_block=64)
    k.items = [
        Instr("FADD", [2], [0, 1]),
        Instr("STG", srcs=[1, 2]),
        Instr("EXIT"),
    ]
    return schedule(k)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_zero_spillable_registers(strategy):
    k = _abi_only_kernel()
    assert spillable(k) == []
    assert make_candidates(k, strategy) == []
    res = demote(k, 0, RegDemOptions(candidate_strategy=strategy))
    assert res.demoted_words == 0
    assert res.kernel.demoted_size == 0


# ---------------------------------------------------------------------------
# edge case: wide (64-bit pair) registers
# ---------------------------------------------------------------------------


def _wide_kernel():
    return _padded_kernel("wide", range(20, 56), [
        Instr("MOV32I", [10], imm=1.0),
        Instr("MOV32I", [11], imm=1.5),
        Instr("DFMA", [10], [10, 10, 10]),   # r10:r11 is a pair
        Instr("MOV32I", [14], imm=2.0),
        Instr("FADD", [14], [14, 14]),
        Instr("STG64", srcs=[1, 10]),
        Instr("STG", srcs=[1, 14], offset=8),
    ])


def test_width_map_marks_pairs():
    widths = width_map(_wide_kernel())
    assert widths[10] == 2
    assert widths[14] == 1


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pair_alias_words_are_not_candidates(strategy):
    """Pairs are demoted through their leading word: the odd alias never
    appears, and the pair carries width 2 into the demotion queue."""
    cands = make_candidates(_wide_kernel(), strategy)
    by_reg = dict(cands)
    assert 11 not in by_reg        # odd alias of the r10:r11 pair
    assert by_reg.get(10) == 2
    assert by_reg.get(14) == 1


def test_wide_demotion_accounts_two_words():
    k = _wide_kernel()
    res = demote(k, 32, RegDemOptions(candidate_strategy="static"))
    assert (10, 2) in res.demoted
    assert res.demoted_words >= 2
    from repro_torch.core.isa import equivalent

    assert equivalent(k, res.kernel)


# ---------------------------------------------------------------------------
# paper-corpus sweep: every strategy yields a usable queue on every benchmark
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PAPER_BENCHMARKS))
def test_all_benchmarks_have_candidates(name):
    k = paper_kernel(name)
    pool = set(spillable(k))
    assert pool
    for strategy in STRATEGIES:
        assert {r for r, _ in make_candidates(k, strategy)} == pool
