"""Property-based tests (hypothesis) for the system's invariants.

``REGDEM_PROPERTY_SCALE`` multiplies every example budget — the nightly CI
workflow sets it to sweep a much larger input space than the per-push run.
"""

import os

import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")

from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

from repro_torch.core.compaction import compact  # noqa: E402
from repro_torch.core.isa import NUM_SMEM_BANKS, equivalent, smem_bank  # noqa: E402
from repro_torch.core.kernelgen import generate, random_profile  # noqa: E402
from repro_torch.core.occupancy import MAXWELL, occupancy  # noqa: E402
from repro_torch.core.regdem import RegDemOptions, auto_targets, demote  # noqa: E402
from repro_torch.core.sched import verify_schedule  # noqa: E402

SCALE = max(1, int(os.environ.get("REGDEM_PROPERTY_SCALE", "1")))

_slow = settings(
    max_examples=15 * SCALE,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)


@given(seed=st.integers(min_value=0, max_value=10_000))
@_slow
def test_generated_kernels_schedule_clean(seed):
    k = generate(random_profile(seed))
    assert verify_schedule(k) == []


@given(seed=st.integers(min_value=0, max_value=10_000))
@_slow
def test_demotion_invariants(seed):
    """For any kernel and any occupancy-cliff target:
    semantics preserved, schedule clean, register count reduced,
    shared-memory accounting exact."""
    k = generate(random_profile(seed))
    targets = auto_targets(k)
    if not targets:
        return
    res = demote(k, targets[0])
    assert equivalent(k, res.kernel)
    assert verify_schedule(res.kernel) == []
    assert res.kernel.reg_count <= k.reg_count
    assert res.kernel.demoted_size == res.demoted_words * k.threads_per_block * 4


@given(
    seed=st.integers(min_value=0, max_value=10_000),
    strategy=st.sampled_from(["static", "cfg", "conflict"]),
    flags=st.tuples(st.booleans(), st.booleans(), st.booleans(), st.booleans()),
)
@settings(max_examples=20 * SCALE, deadline=None, suppress_health_check=[HealthCheck.too_slow])
def test_demotion_options_never_break(seed, strategy, flags):
    k = generate(random_profile(seed % 30))
    targets = auto_targets(k)
    if not targets:
        return
    b, e, r, s = flags
    opt = RegDemOptions(
        candidate_strategy=strategy,
        bank_avoid=b,
        elim_redundant=e,
        reschedule=r,
        substitute=s,
    )
    res = demote(k, targets[-1], opt)
    assert equivalent(k, res.kernel)
    assert verify_schedule(res.kernel) == []


@given(seed=st.integers(min_value=0, max_value=10_000))
@_slow
def test_compaction_idempotent_and_tight(seed):
    k = generate(random_profile(seed))
    kk = k.copy()
    compact(kk)
    once = kk.reg_count
    compact(kk)
    assert kk.reg_count == once  # idempotent
    assert equivalent(k, kk)


@given(
    n_threads=st.sampled_from([32, 64, 128, 192, 256, 512, 1024]),
    static=st.integers(min_value=0, max_value=4096),
    r=st.integers(min_value=0, max_value=24),
)
@settings(max_examples=60 * SCALE, deadline=None)
def test_eq1_layout_bank_conflict_free(n_threads, static, r):
    """Paper eq. 1: for any (threads/block, static smem, demoted index), a
    warp's 32 lanes always touch 32 distinct banks."""
    s_up = (static + 3) // 4 * 4
    banks = [smem_bank(t * 4 + s_up + r * n_threads * 4) for t in range(32)]
    assert len(set(banks)) == NUM_SMEM_BANKS


@given(
    regs=st.integers(min_value=1, max_value=255),
    thr=st.sampled_from([32, 64, 128, 256, 512, 1024]),
    smem=st.integers(min_value=0, max_value=MAXWELL.smem_per_block),
)
@settings(max_examples=100 * SCALE, deadline=None)
def test_occupancy_bounds(regs, thr, smem):
    occ = occupancy(regs, thr, smem)
    assert 0.0 <= occ.occupancy <= 1.0
    assert occ.resident_threads <= MAXWELL.max_threads
    assert occ.resident_warps <= MAXWELL.max_warps
    assert occ.resident_blocks <= MAXWELL.max_blocks
