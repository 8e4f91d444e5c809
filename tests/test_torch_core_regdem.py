"""RegDem algorithm tests: targets, semantics, barriers, layout (paper §3)."""

import itertools

import pytest

from repro_torch.core.candidates import make_candidates, operand_conflicts
from repro_torch.core.isa import NUM_SMEM_BANKS, equivalent, smem_bank
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, all_paper_kernels, generate, random_profile
from repro_torch.core.occupancy import occupancy_of
from repro_torch.core.regdem import REG_FLOOR, RegDemOptions, auto_targets, demote
from repro_torch.core.sched import verify_schedule

KERNELS = all_paper_kernels()


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_demotion_reaches_table1_target(name):
    k = KERNELS[name]
    prof = PAPER_BENCHMARKS[name]
    res = demote(k, prof.regdem_target)
    assert res.kernel.reg_count <= prof.regdem_target
    assert res.reached_target
    # occupancy strictly improves (that is the whole point)
    assert occupancy_of(res.kernel).occupancy > occupancy_of(k).occupancy


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_demotion_preserves_semantics(name):
    k = KERNELS[name]
    res = demote(k, PAPER_BENCHMARKS[name].regdem_target)
    assert equivalent(k, res.kernel)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_demotion_schedule_is_consistent(name):
    k = KERNELS[name]
    res = demote(k, PAPER_BENCHMARKS[name].regdem_target)
    assert verify_schedule(res.kernel) == []


def test_all_option_combinations_safe():
    k = KERNELS["pc"]
    tgt = PAPER_BENCHMARKS["pc"].regdem_target
    for strat in ("static", "cfg", "conflict"):
        for b, e, r, s in itertools.product([False, True], repeat=4):
            opt = RegDemOptions(
                candidate_strategy=strat,
                bank_avoid=b,
                elim_redundant=e,
                reschedule=r,
                substitute=s,
            )
            res = demote(k, tgt, opt)
            assert equivalent(k, res.kernel), opt.label()
            assert verify_schedule(res.kernel) == [], opt.label()


def test_demoted_layout_is_bank_conflict_free():
    """Eq. 1 invariant: all threads of a warp hit distinct smem banks."""
    for n_threads in (64, 128, 256):
        for s in (0, 512, 2052):  # including a non-multiple-of-4 static size
            s_up = (s + 3) // 4 * 4
            for r in range(4):  # demoted register index
                banks = [
                    smem_bank(t * 4 + s_up + r * n_threads * 4) for t in range(32)
                ]
                assert len(set(banks)) == NUM_SMEM_BANKS


def test_demoted_size_accounting():
    k = KERNELS["nn"]
    res = demote(k, 32)
    assert res.kernel.demoted_size == res.demoted_words * k.threads_per_block * 4
    assert res.kernel.total_shared == k.shared_size + res.kernel.demoted_size


def test_stops_at_reg_floor():
    # demotion must not push below 32 registers (no occupancy gain there)
    k = KERNELS["md5hash"]
    res = demote(k, 8)
    assert res.kernel.reg_count >= REG_FLOOR


def test_multiword_demotion_alignment():
    """Force actual FP64-pair demotion: few single-word candidates exist, so
    reaching the target requires demoting aligned pairs (§3.2 extension)."""
    from repro_torch.core.kernelgen import Profile, generate

    prof = Profile(
        name="fp64_heavy",
        target_regs=40,
        threads_per_block=256,
        num_blocks=512,
        shared_size=0,
        regdem_target=32,
        nvcc_spills=0,
        loop_trips=6,
        n_consts=2,
        n_temps=2,
        fp64_frac=1.0,
        loads_per_iter=1,
        seed=77,
    )
    k = generate(prof)
    res = demote(k, 32)
    assert equivalent(k, res.kernel)
    assert verify_schedule(res.kernel) == []
    pairs = [(r, w) for r, w in res.demoted if w == 2]
    assert pairs, "expected at least one demoted FP64 pair"
    # pair demotion uses an even-aligned RDV in the final numbering
    assert res.rdv % 2 == 0
    # per-word slots: every demoted word owns n*4 bytes of shared memory
    assert res.kernel.demoted_size == res.demoted_words * 256 * 4


def test_operand_conflict_pruning():
    k = KERNELS["cfd"]
    conf = operand_conflicts(k)
    res = demote(k, PAPER_BENCHMARKS["cfd"].regdem_target)
    demoted_regs = [r for r, _ in res.demoted]
    # no two demoted registers may conflict (they share one RDV)
    for a, b in itertools.combinations(demoted_regs, 2):
        assert b not in conf.get(a, set()), (a, b)


def test_candidate_strategies_order_and_exclusions():
    k = KERNELS["qtc"]
    for strat in ("static", "cfg", "conflict"):
        cands = make_candidates(k, strat)
        regs = [r for r, _ in cands]
        assert len(regs) == len(set(regs))
        for r in k.live_in:
            assert r not in regs
    with pytest.raises(ValueError):
        make_candidates(k, "bogus")


def test_auto_targets_match_occupancy_cliffs():
    k = KERNELS["cfd"]
    tgts = auto_targets(k)
    assert tgts and tgts[0] < k.reg_count
    occs = [occupancy_of(k).occupancy]
    for t in tgts:
        res = demote(k, t)
        occs.append(occupancy_of(res.kernel).occupancy)
    assert all(b > a for a, b in zip(occs, occs[1:]))


def test_random_kernels_demotable():
    for seed in range(12):
        k = generate(random_profile(seed))
        tgts = auto_targets(k)
        if not tgts:
            continue
        res = demote(k, tgts[0])
        assert equivalent(k, res.kernel), seed
        assert verify_schedule(res.kernel) == [], seed


def test_no_user_smem_traffic_without_static_allocation():
    """Regression (found by the autotuning-search seed sweep): a generated
    kernel with ``shared_size == 0`` must emit no user STS/LDS — offset 0
    is where eq. 1 places the demoted-register slots, so such traffic
    silently corrupted demoted values."""
    from repro_torch.core.kernelgen import Profile

    prof = Profile(
        name="nosmem", target_regs=40, threads_per_block=128, num_blocks=256,
        shared_size=0, regdem_target=34, nvcc_spills=0, smem_ops_per_iter=2,
    )
    k = generate(prof)
    assert {"STS", "LDS"} & {i.op for i in k.instructions()} == set()
    res = demote(k, prof.regdem_target)
    assert equivalent(k, res.kernel)


def test_demotion_on_seed123_regression_kernel():
    """The concrete kernel the bug was found on: random_profile(123) has
    smem ops but no static shared allocation; demotion must stay
    dataflow-equivalent under every candidate strategy."""
    k = generate(random_profile(123))
    for strategy in ("static", "cfg", "conflict"):
        res = demote(k, 32, RegDemOptions(candidate_strategy=strategy))
        assert equivalent(k, res.kernel), strategy
        assert verify_schedule(res.kernel) == [], strategy
