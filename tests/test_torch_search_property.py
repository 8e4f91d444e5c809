"""Property-based tests (hypothesis) for the autotuning search.

The pinned contract: same kernel + same config ⇒ byte-identical winning
kernel and identical report, across repeated runs AND across process-pool
sizes (1 vs N workers); and re-tuning already-tuned content is a pure
translation-cache hit that runs zero pipeline passes.

``REGDEM_PROPERTY_SCALE`` multiplies the example budget (the nightly CI
workflow sweeps a much larger input space than the per-push run).
"""

import os
from unittest import mock

import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")

from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

from repro_torch.binary import dumps  # noqa: E402
from repro_torch.core.isa import equivalent  # noqa: E402
from repro_torch.core.kernelgen import generate, random_profile  # noqa: E402
from repro_torch.core.search import SearchConfig, search  # noqa: E402
from repro_torch.core.simcache import SimCache  # noqa: E402
from repro_torch.core.translator import TranslationService  # noqa: E402

SCALE = max(1, int(os.environ.get("REGDEM_PROPERTY_SCALE", "1")))

#: small bounds keep each example to a handful of pipeline runs
_CFG = dict(max_targets=1, beam_width=3, top_k=2)

_slow = settings(
    max_examples=5 * SCALE,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)


@given(seed=st.integers(min_value=0, max_value=10_000))
@_slow
def test_search_deterministic_across_runs_and_pool_sizes(seed):
    k = generate(random_profile(seed))
    serial = search(k, SearchConfig(workers=0, **_CFG), cache=SimCache())
    again = search(k, SearchConfig(workers=0, **_CFG), cache=SimCache())
    pooled = search(k, SearchConfig(workers=2, **_CFG), cache=SimCache())
    # byte-identical winning kernel ...
    assert dumps(serial.kernel) == dumps(again.kernel) == dumps(pooled.kernel)
    # ... and identical reports (wall time excluded by to_json's contract)
    assert serial.report.to_json() == again.report.to_json()
    assert serial.report.to_json() == pooled.report.to_json()
    # the winner is always a valid translation of the input
    assert equivalent(k, serial.kernel)


@given(seed=st.integers(min_value=0, max_value=10_000))
@_slow
def test_parallel_search_leaves_cache_as_warm_as_serial(seed):
    """Worker caches are merged on join: after the search, the parent cache
    must serve every confirmed variant without re-measuring."""
    k = generate(random_profile(seed))
    cache = SimCache()
    out = search(k, SearchConfig(workers=2, **_CFG), cache=cache)
    assert len(cache) > 0
    # the winner's simulation was measured in a pool worker, merged on join,
    # and is now served from the parent cache without re-simulating
    hit = cache.peek_simulate(out.kernel)
    assert hit is not None
    assert hit.total_cycles == out.report.cycles[out.report.chosen]
    # and the parallel run leaves the exact entry set a serial run leaves
    serial_cache = SimCache()
    search(k, SearchConfig(workers=0, **_CFG), cache=serial_cache)
    assert sorted(map(repr, serial_cache.export()["sims"])) == sorted(
        map(repr, cache.export()["sims"])
    )
    assert sorted(map(repr, serial_cache.export()["stalls"])) == sorted(
        map(repr, cache.export()["stalls"])
    )


@given(seed=st.integers(min_value=0, max_value=10_000), workers=st.sampled_from([0, 2]))
@_slow
def test_retune_is_pure_cache_hit(seed, workers):
    """Tuning a container twice: the second pass is all cache hits, runs
    zero pipeline passes, and emits byte-identical container bytes — even
    when the second call uses a different pool size (the pool size is not
    part of the cache key)."""
    from repro_torch.core import passes as passes_mod

    blob = dumps([generate(random_profile(seed))])
    svc = TranslationService()
    cfg1 = SearchConfig(workers=workers, **_CFG)
    cfg2 = SearchConfig(workers=2 - workers, **_CFG)
    out1, batch1 = svc.tune(blob, cfg1)
    assert batch1.cached == [False]

    with mock.patch.object(
        passes_mod.PassPipeline,
        "run",
        side_effect=AssertionError("pipeline pass ran on the cached path"),
    ):
        out2, batch2 = svc.tune(blob, cfg2)
    assert batch2.cached == [True]
    assert out2 == out1
