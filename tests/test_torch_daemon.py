"""TranslationDaemon: serving semantics, deadlines, retries, degradation,
restart durability."""

import pytest

from repro_torch.binary import dumps, kernel_names, loads_many
from repro_torch.core.artifacts import ArtifactStore
from repro_torch.core.kernelgen import paper_kernel
from repro_torch.core.passes import PIPELINE_COUNTERS
from repro_torch.core.search import SearchConfig
from repro_torch.core.translator import TranslationService
from repro_torch.runtime import DaemonConfig, TranslationDaemon
from repro_torch.testing import FaultPlan
from repro_torch.testing import injected as faults_injected

SMALL_TUNE = SearchConfig(max_targets=1, beam_width=2, top_k=1)


def _blob(*names):
    ks = [paper_kernel(n) for n in names]
    return dumps(ks[0]) if len(ks) == 1 else dumps(ks)


def test_lifecycle_and_submit_guard():
    d = TranslationDaemon()
    with pytest.raises(RuntimeError, match="not running"):
        d.submit(b"x")
    with d:
        with pytest.raises(ValueError, match="unknown mode"):
            d.submit(b"x", mode="optimize")
    d.stop()  # idempotent


def test_translate_matches_service_bytes():
    data = _blob("md5hash", "conv")
    expected, _ = TranslationService().translate(data)
    with TranslationDaemon() as d:
        resp = d.request(data)
    assert resp.ok and not resp.degraded
    assert resp.payload == expected
    assert resp.attempts == 1
    assert resp.report.kernel_names == ["md5hash", "conv"]


def test_tune_matches_service_bytes():
    data = _blob("md5hash")
    expected, _ = TranslationService().tune(data, SMALL_TUNE)
    with TranslationDaemon() as d:
        resp = d.request(data, mode="tune", config=SMALL_TUNE)
    assert resp.ok
    assert resp.payload == expected


def test_concurrent_submissions_all_complete():
    blobs = [_blob(n) for n in ("md5hash", "conv", "nn")]
    with TranslationDaemon(config=DaemonConfig(max_batch=3)) as d:
        handles = [d.submit(b) for b in blobs * 2]
        responses = [h.result(timeout=60) for h in handles]
    assert all(r.ok for r in responses)
    for blob, resp in zip(blobs * 2, responses):
        assert kernel_names(resp.payload) == kernel_names(blob)
    snap = d.metrics_snapshot()
    assert snap["requests"] == 6 and snap["ok"] == 6


def test_invalid_input_is_clean_error():
    with TranslationDaemon() as d:
        resp = d.request(b"not a container")
    assert resp.status == "error"
    assert resp.payload is None
    assert "invalid input container" in resp.reason
    assert d.metrics_snapshot()["errors"] == 1


def test_deadline_degrades_to_baseline_bytes():
    data = _blob("md5hash")
    with TranslationDaemon(config=DaemonConfig(deadline_s=0.0)) as d:
        resp = d.request(data, mode="tune")
    assert resp.degraded
    assert "deadline" in resp.reason
    # degraded payload is the verified do-nothing emission of the input
    from repro_torch.binary.roundtrip import verified_dumps_many

    assert resp.payload == verified_dumps_many(loads_many(data))
    assert d.metrics_snapshot()["deadline_timeouts"] >= 1


def test_per_request_deadline_override():
    data = _blob("md5hash")
    with TranslationDaemon(config=DaemonConfig(deadline_s=60.0)) as d:
        resp = d.request(data, mode="tune", deadline_s=0.0)
    assert resp.degraded


def test_transient_fault_retry_then_success():
    """One injected failure on attempt 0; the retry serves the fault-free
    bytes — retries are invisible to the caller except in the count."""
    data = _blob("md5hash")
    expected, _ = TranslationService().translate(data)
    plan = FaultPlan(schedule={("daemon.error", "1"): 1})
    with faults_injected(plan):
        with TranslationDaemon(config=DaemonConfig(backoff_s=0.001)) as d:
            resp = d.request(data)
    assert resp.ok
    assert resp.payload == expected
    assert resp.attempts == 2
    assert d.metrics_snapshot()["retries"] == 1


def test_exhausted_retries_degrade():
    data = _blob("md5hash")
    plan = FaultPlan(error_p=1.0)  # every attempt fails
    with faults_injected(plan):
        cfg = DaemonConfig(max_retries=2, backoff_s=0.001)
        with TranslationDaemon(config=cfg) as d:
            resp = d.request(data)
    assert resp.degraded
    assert "after 3 attempt" in resp.reason
    from repro_torch.binary.roundtrip import verified_dumps_many

    assert resp.payload == verified_dumps_many(loads_many(data))
    snap = d.metrics_snapshot()
    assert snap["retries"] == 3 and snap["degraded"] == 1
    assert snap["degradation_rate"] == 1.0


def test_latency_injection_bounded_by_deadline():
    """A hung translation cannot hold a response past its deadline."""
    import time

    data = _blob("md5hash")
    plan = FaultPlan(latency_p=1.0, latency_s=30.0)
    with faults_injected(plan):
        cfg = DaemonConfig(deadline_s=0.3)
        with TranslationDaemon(config=cfg) as d:
            t0 = time.monotonic()
            resp = d.request(data)
            elapsed = time.monotonic() - t0
    assert resp.degraded
    assert elapsed < 5.0  # far below the injected 30s hang


def test_warm_restart_serves_tuned_kernel_with_zero_passes(tmp_path):
    """The acceptance bar: daemon restart, same store dir — repeat
    content is served byte-identically from disk without running a single
    pipeline pass, and counted as a disk cache hit."""
    data = _blob("md5hash")
    with TranslationDaemon(store=ArtifactStore(str(tmp_path))) as d:
        first = d.request(data, mode="tune", config=SMALL_TUNE)
    assert first.ok

    svc = TranslationService(store=ArtifactStore(str(tmp_path)))
    with TranslationDaemon(service=svc) as d2:
        before = dict(PIPELINE_COUNTERS)
        again = d2.request(data, mode="tune", config=SMALL_TUNE)
        after = dict(PIPELINE_COUNTERS)
    assert again.ok
    assert again.payload == first.payload
    assert after["passes"] == before["passes"]
    assert after["pipelines"] == before["pipelines"]
    snap = d2.metrics_snapshot()
    assert snap["service"]["cache"]["disk_hits"] == 1
    assert snap["service"]["cache"]["disk_hit_rate"] > 0
    assert snap["service"]["store"]["hits"] >= 1


def test_rejects_service_and_store():
    with pytest.raises(ValueError):
        TranslationDaemon(service=TranslationService(), store=object())


def test_metrics_snapshot_shape():
    with TranslationDaemon() as d:
        d.request(_blob("md5hash"))
        snap = d.metrics_snapshot()
    assert snap["running"] is True
    assert snap["completed"] == 1 and snap["inflight"] == 0
    assert snap["serve_ms"]["count"] == 1
    for key in ("requests", "ok", "degraded", "errors", "retries",
                "deadline_timeouts", "late_results", "degradation_rate"):
        assert key in snap
    assert "cache" in snap["service"]
