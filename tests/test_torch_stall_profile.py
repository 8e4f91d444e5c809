"""Stall-attribution tests.

The contract under test: ``simulate(k, profile=True)`` charges **every**
idle issue-slot cycle to exactly one (static instruction, reason) bucket —
so the profile's books balance exactly against ``SimResult.issue_stalls``
on all nine paper benchmarks x every registered architecture — and the
profiled run is cycle-identical to the unprofiled one (attribution is an
observer, never a perturbation).  One kernel's full profile is pinned
against ``tests/golden/stall_profile.json``.
"""

import json
import os

import pytest

from repro_torch.arch import retarget
from repro_torch.arch.registry import arch_names
from repro_torch.binary import overlay
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, paper_kernel
from repro_torch.core.search import SearchConfig, search
from repro_torch.core.simcache import SimCache
from repro_torch.core.simulator import simulate
from repro_torch.obs import REASONS, build_profile

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "stall_profile.json")

ARCHES = sorted(arch_names())
BENCHMARKS = sorted(PAPER_BENCHMARKS)


def _profiled(name: str, arch: str):
    k = retarget(paper_kernel(name), arch)
    return k, simulate(k, profile=True)


# ---------------------------------------------------------------------------
# exactness: the books balance on every benchmark x arch cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("name", BENCHMARKS)
def test_attribution_balances_exactly(name, arch):
    k, res = _profiled(name, arch)
    p = res.stall_profile
    assert p is not None
    assert p.kernel_name == k.name and p.arch == arch
    # the three levels of the ledger agree to the cycle
    assert p.total == res.issue_stalls
    assert sum(p.per_reason.values()) == p.total
    assert sum(e.total for e in p.instructions) == p.total
    for e in p.instructions:
        assert e.total == sum(e.reasons.values())
        assert set(e.reasons) <= set(REASONS)
        assert e.total > 0  # only nonzero entries are kept
    # entries are in static program order with valid indices
    indices = [e.index for e in p.instructions]
    assert indices == sorted(indices)
    n_instrs = sum(1 for it in k.items if hasattr(it, "ctrl"))
    assert all(0 <= i < n_instrs for i in indices)


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("name", BENCHMARKS)
def test_profiling_is_a_pure_observer(name, arch):
    """Attribution must never perturb the simulation it measures."""
    k = retarget(paper_kernel(name), arch)
    plain = simulate(k)
    profiled = simulate(k, profile=True)
    assert profiled.total_cycles == plain.total_cycles
    assert profiled.cycles_per_wave == plain.cycles_per_wave
    assert profiled.issue_stalls == plain.issue_stalls
    assert plain.stall_profile is None


def test_golden_pinned_profile():
    """The full md5hash/maxwell attribution, pinned cycle-for-cycle."""
    _, res = _profiled("md5hash", "maxwell")
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    assert res.stall_profile.to_json() == golden


# ---------------------------------------------------------------------------
# build_profile refuses books that don't balance
# ---------------------------------------------------------------------------


def test_unbalanced_blame_raises():
    k = paper_kernel("md5hash")
    uid = next(it.uid for it in k.items if hasattr(it, "ctrl"))
    with pytest.raises(AssertionError, match="does not balance"):
        build_profile(k, {(uid, "issue_stall"): 3}, total=4)


def test_unknown_instruction_blame_raises():
    k = paper_kernel("md5hash")
    with pytest.raises(AssertionError, match="not in the kernel"):
        build_profile(k, {(-12345, "issue_stall"): 3}, total=3)


# ---------------------------------------------------------------------------
# renderings: hot list, text table, overlay column
# ---------------------------------------------------------------------------


def test_hot_and_render():
    _, res = _profiled("md5hash", "maxwell")
    p = res.stall_profile
    hot = p.hot(3)
    assert len(hot) == 3
    assert hot[0].total == max(e.total for e in p.instructions)
    assert [e.total for e in hot] == sorted((e.total for e in hot), reverse=True)
    text = p.render(top=3)
    assert f"{p.total} stall cycles" in text
    for reason, cycles in p.per_reason.items():
        if cycles:
            assert reason in text


def test_overlay_profile_column():
    k = paper_kernel("md5hash")
    p = simulate(k, profile=True).stall_profile
    plain = overlay(k).splitlines()
    profiled = overlay(k, profile=p).splitlines()
    assert any("stall profile:" in ln for ln in profiled)
    assert not any("stall profile:" in ln for ln in plain)
    # exactly the blamed instructions gain the cycles/share/reason suffix
    annotated = [ln for ln in profiled if " |" in ln and "%" in ln]
    assert len(annotated) == len(p.instructions)
    top = p.hot(1)[0]
    assert any(top.top_reason in ln for ln in annotated)


# ---------------------------------------------------------------------------
# SimCache.profile: profiled results are cached like plain simulations
# ---------------------------------------------------------------------------


def test_simcache_profile_hits_and_stats():
    cache = SimCache()
    k = paper_kernel("nn")
    first = cache.profile(k)
    misses = cache.misses
    second = cache.profile(k)
    assert cache.misses == misses  # pure hit
    assert second.to_json() == first.to_json()
    assert cache.stats()["profile_entries"] >= 1
    # the plain-simulation table was warmed too, without a profile attached
    plain = cache.simulate(k)
    assert cache.misses == misses
    assert plain.stall_profile is None
    assert plain.issue_stalls == first.total


# ---------------------------------------------------------------------------
# search integration: SearchConfig(profile=True)
# ---------------------------------------------------------------------------


def test_search_reports_stall_profiles():
    cfg = SearchConfig(profile=True, archs=("maxwell",), beam_width=2, top_k=2)
    report = search(paper_kernel("md5hash"), cfg).report
    assert report.stall_profiles
    assert report.chosen in report.stall_profiles
    for label, prof in report.stall_profiles.items():
        assert prof.total == sum(e.total for e in prof.instructions)
    payload = report.to_json()
    assert set(payload["stall_profiles"]) == set(report.stall_profiles)
    # profile participates in the cache signature: a profiled and an
    # unprofiled search are distinct translation-cache entries
    assert cfg.signature() != SearchConfig(
        profile=False, archs=("maxwell",), beam_width=2, top_k=2
    ).signature()


def test_unprofiled_search_has_no_profiles():
    cfg = SearchConfig(archs=("maxwell",), beam_width=2, top_k=2)
    report = search(paper_kernel("md5hash"), cfg).report
    assert report.stall_profiles == {}
    assert report.to_json()["stall_profiles"] == {}
