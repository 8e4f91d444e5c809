"""Differential property test (hypothesis): the batched simulator entry
point is element-wise identical to per-variant simulation.

``simulate_batch`` reorders its inputs by schedule-signature prefix and
resumes runs from mid-trace checkpoints captured by sibling kernels — both
are pure scheduling moves, so for ANY variant set the results (cycle
counts, idle books, truncation flags, and ``profile=True`` stall books)
must match a fresh per-variant :func:`simulate` exactly.

``REGDEM_PROPERTY_SCALE`` multiplies the example budget (the nightly CI
workflow sweeps a much larger input space than the per-push run).
"""

import os

import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")

from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.core.kernelgen import generate, random_profile
from repro_torch.core.regdem import auto_targets, demote
from repro_torch.core.simcache import SimCache
from repro_torch.core.simulator import simulate, simulate_batch

SCALE = max(1, int(os.environ.get("REGDEM_PROPERTY_SCALE", "1")))

_slow = settings(
    max_examples=5 * SCALE,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)


def _variant_set(seed: int):
    """A realistic sibling set: one random kernel, its demotions (schedule
    prefixes shared with the base), and a content-duplicate (dedup path)."""
    base = generate(random_profile(seed))
    variants = [base]
    for target in auto_targets(base)[:2]:
        variants.append(demote(base, target).kernel)
    variants.append(base.copy())
    return variants


def _assert_same(a, b):
    assert a.total_cycles == b.total_cycles
    assert a.issue_stalls == b.issue_stalls
    assert a.truncated == b.truncated
    if a.stall_profile is None or b.stall_profile is None:
        assert a.stall_profile is None and b.stall_profile is None
    else:
        assert a.stall_profile.to_json() == b.stall_profile.to_json()


@given(seed=st.integers(min_value=0, max_value=10_000))
@_slow
def test_simulate_batch_elementwise_identical(seed):
    variants = _variant_set(seed)
    solo = [simulate(k) for k in variants]
    batched = simulate_batch(variants)
    for a, b in zip(solo, batched):
        _assert_same(a, b)


@given(seed=st.integers(min_value=0, max_value=10_000))
@_slow
def test_simulate_batch_profiled_books_identical(seed):
    """The profiled engine's stall-attribution books survive checkpoint
    resume and batch reordering bit-for-bit."""
    variants = _variant_set(seed)
    solo = [simulate(k, profile=True) for k in variants]
    batched = simulate_batch(variants, profile=True)
    for a, b in zip(solo, batched):
        _assert_same(a, b)


@given(seed=st.integers(min_value=0, max_value=10_000))
@_slow
def test_simulate_batch_through_cache_identical(seed):
    """The cache-backed path (what the search confirm stage runs) returns
    the same results; content-duplicate members dedup to one measurement."""
    variants = _variant_set(seed)
    solo = [simulate(k) for k in variants]
    cache = SimCache()
    batched = simulate_batch(variants, cache=cache)
    for a, b in zip(solo, batched):
        _assert_same(a, b)
    # the duplicate (last member copies the first) was served from cache
    assert cache.hits >= 1
