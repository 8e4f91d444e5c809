"""Persistent artifact store: integrity, recovery, eviction, cache spill."""

import os

import pytest

from repro_torch.core.artifacts import ArtifactStore
from repro_torch.core.simcache import SimCache
from repro_torch.core.translator import TranslationCache, TranslationService
from repro_torch.binary import dumps
from repro_torch.core.kernelgen import paper_kernel
from repro_torch.testing import FaultPlan
from repro_torch.testing import injected as faults_injected


def test_put_get_roundtrip(tmp_path):
    store = ArtifactStore(str(tmp_path))
    assert store.get("k") is None
    assert store.misses == 1
    assert store.put("k", b"payload", meta={"x": 1})
    payload, meta = store.get("k")
    assert payload == b"payload"
    assert meta["x"] == 1
    assert meta["key"] == "k"  # collision guard rides in the meta
    assert store.hits == 1 and store.puts == 1
    assert len(store) == 1


def test_overwrite_and_binary_payloads(tmp_path):
    store = ArtifactStore(str(tmp_path))
    blob = bytes(range(256)) * 7
    store.put("k", b"old")
    store.put("k", blob)
    payload, _ = store.get("k")
    assert payload == blob
    assert len(store) == 1


def test_persists_across_instances(tmp_path):
    ArtifactStore(str(tmp_path)).put("k", b"v", meta={"n": 2})
    reopened = ArtifactStore(str(tmp_path))
    payload, meta = reopened.get("k")
    assert payload == b"v" and meta["n"] == 2


def test_corrupt_entry_quarantined_not_served(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.put("k", b"precious bytes")
    path = store._path("k")
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF  # flip payload bits on disk
    with open(path, "wb") as fh:
        fh.write(bytes(raw))
    assert store.get("k") is None  # miss, never wrong bytes
    assert store.quarantined == 1
    assert not os.path.exists(path)  # moved aside...
    assert os.listdir(store.quarantine_dir)  # ...kept for post-mortem
    # the slot is reusable after quarantine
    store.put("k", b"recomputed")
    assert store.get("k")[0] == b"recomputed"


def test_truncated_entry_is_a_miss(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.put("k", b"x" * 100)
    path = store._path("k")
    raw = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(raw[: len(raw) // 2])
    assert store.get("k") is None
    assert store.quarantined == 1


def test_lru_eviction_is_deterministic(tmp_path):
    store = ArtifactStore(str(tmp_path), max_entries=2)
    store.put("a", b"1")
    store.put("b", b"2")
    os.utime(store._path("a"), (1.0, 1.0))  # "a" is stalest
    os.utime(store._path("b"), (2.0, 2.0))
    store.put("c", b"3")
    assert len(store) == 2
    assert store.evictions == 1
    assert store.get("a") is None  # the stale one went
    assert store.get("b")[0] == b"2"
    assert store.get("c")[0] == b"3"


def test_crash_mid_write_self_heals_on_restart(tmp_path):
    """A write that dies before its rename leaves only a tmp file; the next
    open sweeps it and the entry is simply absent — never half-read."""
    store = ArtifactStore(str(tmp_path))
    plan = FaultPlan(schedule={("store.tmp", "k"): 1})
    with faults_injected(plan):
        assert store.put("k", b"never lands") is False
    leftovers = [
        name
        for _, _, files in os.walk(store.objects_dir)
        for name in files
        if name.endswith(".tmp")
    ]
    assert leftovers  # the simulated crash left debris
    reopened = ArtifactStore(str(tmp_path))
    assert reopened.recovered >= 1
    assert reopened.get("k") is None
    assert not any(
        name.endswith(".tmp")
        for _, _, files in os.walk(reopened.objects_dir)
        for name in files
    )
    # and the store still works
    reopened.put("k", b"lands now")
    assert reopened.get("k")[0] == b"lands now"


def test_torn_write_caught_on_read(tmp_path):
    store = ArtifactStore(str(tmp_path))
    plan = FaultPlan(schedule={("store.torn", "k"): 1})
    with faults_injected(plan):
        store.put("k", b"torn to shreds")
    assert store.get("k") is None
    assert store.quarantined == 1


def test_bit_flip_on_read_caught(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.put("k", b"x" * 64)
    plan = FaultPlan(bit_flip_p=1.0)
    with faults_injected(plan) as inj:
        assert store.get("k") is None
        assert inj.counts()["store.flip"] >= 1
    assert store.quarantined == 1


def test_warm_load_serves_only_verified_entries(tmp_path):
    """Restart after a partial corruption: the intact entry warm-loads, the
    corrupt one is quarantined — self-healing, no manual intervention."""
    store = ArtifactStore(str(tmp_path))
    store.put("good", b"good bytes")
    store.put("bad", b"bad bytes")
    path = store._path("bad")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(path, "wb") as fh:
        fh.write(bytes(raw))
    reopened = ArtifactStore(str(tmp_path))
    assert reopened.get("good")[0] == b"good bytes"
    assert reopened.get("bad") is None
    assert reopened.quarantined == 1


def test_stats_shape(tmp_path):
    store = ArtifactStore(str(tmp_path), max_entries=10)
    store.put("k", b"v")
    store.get("k")
    store.get("missing")
    s = store.stats()
    assert s["entries"] == 1 and s["capacity"] == 10
    assert s["hits"] == 1 and s["misses"] == 1 and s["puts"] == 1
    assert s["hit_rate"] == 0.5


# -- cache spill / warm-load ---------------------------------------------------


def test_translation_cache_spills_and_warm_loads(tmp_path):
    blob = dumps(paper_kernel("md5hash"))
    svc = TranslationService(store=ArtifactStore(str(tmp_path)))
    out, rep = svc.translate(blob)
    assert rep.cached == [False]

    # fresh process: new cache, same store directory
    svc2 = TranslationService(store=ArtifactStore(str(tmp_path)))
    out2, rep2 = svc2.translate(blob)
    assert rep2.cached == [True]  # served from disk, not recomputed
    assert out2 == out  # byte-identical across the restart
    assert svc2.cache.disk_hits == 1
    snap = svc2.metrics_snapshot()
    assert snap["cache"]["disk_hits"] == 1
    assert "store" in snap


def test_translation_service_rejects_cache_and_store():
    with pytest.raises(ValueError):
        TranslationService(cache=TranslationCache(), store=object())


def test_simcache_spills_and_warm_loads(tmp_path):
    k = paper_kernel("md5hash")
    c1 = SimCache(store=ArtifactStore(str(tmp_path)))
    r1 = c1.simulate(k)
    s1 = c1.estimate_stalls(k, 0.5)

    c2 = SimCache(store=ArtifactStore(str(tmp_path)))
    r2 = c2.simulate(k)
    s2 = c2.estimate_stalls(k, 0.5)
    assert r2.total_cycles == r1.total_cycles
    assert s2 == s1
    assert c2.disk_hits == 2
    assert c2.stats()["disk_hits"] == 2
    # second access within the process is a pure memory hit
    c2.simulate(k)
    assert c2.disk_hits == 2
