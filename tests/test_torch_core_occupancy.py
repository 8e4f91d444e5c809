"""Occupancy-calculator tests against the paper's Table 1 anchor points."""

import pytest

from repro_torch.core.kernelgen import PAPER_BENCHMARKS, all_paper_kernels
from repro_torch.core.occupancy import MAXWELL, occupancy, occupancy_of, spill_targets


# (regs, threads/block, smem) -> theoretical occupancy on CC 5.2
TABLE1_POINTS = [
    ("cfd", 68, 192, 0, 0.375),
    ("cfd@56", 56, 192, 0, 0.5625),
    ("qtc", 55, 64, 512, 0.5625),
    ("md5hash", 33, 256, 0, 0.75),
    ("md5hash@32", 32, 256, 0, 1.0),
    ("gaussian", 43, 64, 0, 0.65625),
    ("conv", 35, 128, 0, 0.75),
]


@pytest.mark.parametrize("name,regs,thr,smem,expect", TABLE1_POINTS)
def test_table1_theoretical_occupancy(name, regs, thr, smem, expect):
    assert occupancy(regs, thr, smem).occupancy == pytest.approx(expect)


def test_occupancy_is_step_function():
    # paper §2: occupancy is a step function of register count
    prev = None
    distinct = set()
    for regs in range(32, 80):
        occ = occupancy(regs, 192, 0).occupancy
        if prev is not None:
            assert occ <= prev + 1e-9  # monotone non-increasing in regs
        prev = occ
        distinct.add(occ)
    assert 3 <= len(distinct) <= 12  # cliffs, not a smooth slope


def test_register_limited_benchmarks():
    # every Table-1 benchmark must be register-limited (the paper's premise)
    for name, k in all_paper_kernels().items():
        assert occupancy_of(k).limiter == "registers", name


def test_spill_targets_hit_paper_targets():
    for name, prof in PAPER_BENCHMARKS.items():
        k_regs = prof.target_regs
        cliffs = spill_targets(k_regs, prof.threads_per_block, prof.shared_size)
        assert prof.regdem_target in cliffs, (name, cliffs)


def test_spill_targets_respect_smem_budget():
    # with no shared memory left, no spill target may be offered
    assert spill_targets(64, 256, 0, available_smem=0) == []


def test_smem_limits_enforced():
    with pytest.raises(ValueError):
        occupancy(32, 256, MAXWELL.smem_per_block + 1)
    with pytest.raises(ValueError):
        occupancy(300, 256, 0)


def test_occupancy_counts_demoted_smem():
    # demoted registers consume shared memory: at some point the smem cost
    # cancels the register gain and the cliff list stops
    cliffs = spill_targets(80, 1024, 40 * 1024)
    for tgt in cliffs:
        spilled = 80 - tgt
        assert 40 * 1024 + spilled * 1024 * 4 <= MAXWELL.smem_per_block
