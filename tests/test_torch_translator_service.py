"""Batch, cached, multi-kernel translation-service tests (acceptance: a v2
multi-kernel container round-trips through translate_binary, and a repeated
kernel is served from the cache byte-identically with zero pipeline passes)."""

import pytest

from repro_torch.binary import dumps, kernel_crc, kernel_names, loads, loads_many
from repro_torch.core.isa import equivalent
from repro_torch.core.kernelgen import paper_kernel
from repro_torch.core.passes import PIPELINE_COUNTERS
from repro_torch.core.regdem import RegDemOptions
from repro_torch.core.sched import verify_schedule
from repro_torch.core.translator import (
    BatchTranslationReport,
    TranslationCache,
    TranslationReport,
    TranslationService,
    translate_binary,
)

OPTS = [RegDemOptions()]  # one option set keeps the enumeration cheap


@pytest.fixture(scope="module")
def service():
    return TranslationService(options=OPTS)


def test_batch_translates_every_kernel(service):
    a, b = paper_kernel("md5hash"), paper_kernel("conv")
    out, rep = service.translate(dumps([a, b]))
    assert isinstance(rep, BatchTranslationReport)
    assert rep.kernel_names == ["md5hash", "conv"]
    decoded = loads_many(out)
    assert kernel_names(out) == ["md5hash", "conv"]
    for orig, dec in zip([a, b], decoded):
        assert equivalent(orig, dec)
        assert verify_schedule(dec) == []


def test_repeated_kernel_served_from_cache(service):
    """The headline cache guarantee: a repeated kernel in a batch runs zero
    pipeline passes and produces byte-identical output."""
    a = paper_kernel("md5hash")
    blob = dumps([a, a.copy(), a.copy()])
    before = dict(PIPELINE_COUNTERS)
    out, rep = service.translate(blob)
    after = dict(PIPELINE_COUNTERS)
    # md5hash was already translated by the previous test through this
    # service: all three batch entries hit the cache, zero passes run
    assert rep.cached == [True, True, True]
    assert rep.cache_hits == 3 and rep.cache_misses == 0
    assert after["passes"] == before["passes"]
    assert after["pipelines"] == before["pipelines"]
    # byte-identical per-kernel output: all three decode to the same render
    k0, k1, k2 = loads_many(out)
    assert k0.render() == k1.render() == k2.render()
    assert kernel_crc(k0) == kernel_crc(k1) == kernel_crc(k2)


def test_warm_service_is_byte_stable(service):
    a, b = paper_kernel("md5hash"), paper_kernel("conv")
    blob = dumps([a, b])
    out1, _ = service.translate(blob)
    out2, rep2 = service.translate(blob)
    assert out1 == out2
    assert rep2.cache_hits == 2 and rep2.hit_rate == 1.0


def test_cache_key_separates_translation_parameters():
    a = paper_kernel("md5hash")
    cache = TranslationCache()
    blob = dumps(a)
    translate_binary(blob, options=OPTS, cache=cache)
    assert (cache.hits, cache.misses) == (0, 1)
    # same kernel, same parameters -> hit
    translate_binary(blob, options=OPTS, cache=cache)
    assert (cache.hits, cache.misses) == (1, 1)
    # different target -> different key -> miss
    translate_binary(blob, target_regs=32, options=OPTS, cache=cache)
    assert (cache.hits, cache.misses) == (1, 2)
    assert len(cache) == 2


def test_single_kernel_contract_unchanged():
    """translate_binary on a single-kernel container still returns the
    kernel's TranslationReport (the historical contract)."""
    a = paper_kernel("md5hash")
    out, rep = translate_binary(dumps(a), options=OPTS)
    assert isinstance(rep, TranslationReport)
    assert rep.kernel_name == "md5hash"
    chosen = loads(out)
    assert equivalent(a, chosen)
    # per-pass stats surface for every considered variant
    assert rep.pass_stats and all(stats for stats in rep.pass_stats.values())
    assert rep.total_pipeline_seconds > 0.0


def test_cache_crc_collision_served_as_miss():
    """A CRC collision must never serve another kernel's translation: the
    stored input rendering is compared on every hit."""
    a, b = paper_kernel("md5hash"), paper_kernel("nn")
    cache = TranslationCache()
    key = cache.key(a, None, OPTS, True)
    cache.put(key, a, a, None)
    # same key, different kernel (simulated 32-bit CRC collision)
    assert cache.get(key, b) is None
    assert cache.get(key, a) is not None
    assert (cache.hits, cache.misses) == (1, 1)


def test_cache_bound_evicts_fifo():
    cache = TranslationCache(max_entries=1)
    a, b = paper_kernel("md5hash"), paper_kernel("nn")
    translate_binary(dumps(a), options=OPTS, cache=cache)
    translate_binary(dumps(b), options=OPTS, cache=cache)  # evicts a
    assert len(cache) == 1
    translate_binary(dumps(a), options=OPTS, cache=cache)
    assert cache.hits == 0 and cache.misses == 3
    stats = cache.stats()
    assert stats["evictions"] == 2
    assert stats["capacity"] == 1
    assert stats["entries"] == 1
    assert stats["hit_rate"] == 0.0


def test_cache_stats_and_shared_hit_rate():
    cache = TranslationCache()
    a = paper_kernel("md5hash")
    translate_binary(dumps(a), options=OPTS, cache=cache)
    translate_binary(dumps(a), options=OPTS, cache=cache)
    stats = cache.stats()
    assert (stats["hits"], stats["misses"], stats["evictions"]) == (1, 1, 0)
    assert stats["hit_rate"] == 0.5 == cache.hit_rate


def test_service_metrics_snapshot():
    service = TranslationService(options=OPTS)
    a = paper_kernel("md5hash")
    service.translate(dumps([a, a.copy()]))
    service.translate(dumps(a))
    snap = service.metrics_snapshot()
    assert snap["calls"] == 2
    assert snap["kernels"] == 3
    assert snap["kernels_per_s"] > 0
    lat = snap["translate_ms"]
    assert lat["count"] == 2
    assert 0 < lat["p50"] <= lat["p99"]
    assert lat["p99"] == pytest.approx(lat["max"], rel=1e-4)
    # one cold miss, then two in-batch + one cross-call hit
    assert snap["cache"]["hits"] == 2
    assert snap["cache"]["misses"] == 1
    assert snap["cache"]["hit_rate"] == pytest.approx(2 / 3, abs=1e-3)
