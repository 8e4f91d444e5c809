"""Fault-tolerant translation serving: the TranslationDaemon walkthrough.

Brings up a :class:`repro_torch.runtime.TranslationDaemon` over a persistent
artifact store, serves a mixed translate/tune workload, restarts the daemon
over the same store directory to show the warm-start path (repeat content
served byte-identically from disk, zero pipeline passes), then replays the
workload under an injected fault storm to show graceful degradation — every
response is either the fault-free bytes or an explicitly ``degraded``
baseline emission.

The counterpart of ``examples/serve_daemon.py`` over ``repro_torch`` alone:
for the same arguments it prints what the reference prints, but for the
latencies and the temporary store's name.  The translator is host code and
the example makes no tensor, so it takes no ``--device``.

    PYTHONPATH=src python examples/torch_serve_daemon.py
    PYTHONPATH=src python examples/torch_serve_daemon.py --store /tmp/regdem_store
    PYTHONPATH=src python examples/torch_serve_daemon.py --chaos

Pass ``--store DIR`` to keep the artifact store between invocations and
watch the second run serve everything from disk.  ``--chaos`` adds the
fault-storm phase (deterministic: same seed, same outcome, every run).
"""

import argparse
import shutil
import tempfile
import time

from repro_torch.binary import dumps, kernel_names, loads_many
from repro_torch.binary.roundtrip import verified_dumps_many
from repro_torch.core.artifacts import ArtifactStore
from repro_torch.core.kernelgen import paper_kernel
from repro_torch.core.passes import PIPELINE_COUNTERS
from repro_torch.core.search import SearchConfig
from repro_torch.core.translator import TranslationService
from repro_torch.runtime import DaemonConfig, TranslationDaemon
from repro_torch.testing import FaultPlan, injected

TUNE = SearchConfig(max_targets=1, beam_width=2, top_k=1)


def workload():
    """(data, mode) request mix: three translates and one autotune."""
    blobs = [dumps(paper_kernel(n)) for n in ("md5hash", "conv", "nn")]
    return [(b, "translate") for b in blobs] + [(blobs[0], "tune")]


def drive(daemon, requests):
    t0 = time.perf_counter()
    handles = [
        daemon.submit(data, mode=mode, config=TUNE if mode == "tune" else None)
        for data, mode in requests
    ]
    responses = [h.result(timeout=120) for h in handles]
    wall = time.perf_counter() - t0
    for (data, mode), resp in zip(requests, responses):
        names = ",".join(kernel_names(data))
        print(f"  {mode:<9} [{names:<18}] {resp.status:<8} "
              f"attempts={resp.attempts} {resp.latency_s * 1e3:7.1f} ms")
    print(f"  {len(responses)} responses in {wall * 1e3:.0f} ms")
    return responses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="artifact-store directory (default: a temp dir)")
    ap.add_argument("--chaos", action="store_true",
                    help="replay the workload under an injected fault storm")
    args = ap.parse_args()

    store_root = args.store or tempfile.mkdtemp(prefix="regdem_daemon_")
    requests = workload()
    try:
        print(f"== cold serve (store: {store_root}) ==")
        with TranslationDaemon(store=ArtifactStore(store_root)) as daemon:
            drive(daemon, requests)
            snap = daemon.metrics_snapshot()
            print(f"  store: {snap['service']['store']['entries']} entries, "
                  f"cache hit rate {snap['service']['cache']['hit_rate']:.2f}")

        print("\n== warm restart: fresh daemon, same store directory ==")
        svc = TranslationService(store=ArtifactStore(store_root))
        with TranslationDaemon(service=svc) as daemon:
            passes0 = PIPELINE_COUNTERS["passes"]
            drive(daemon, requests)
            zero = PIPELINE_COUNTERS["passes"] == passes0
        print(f"  pipeline passes run: {'ZERO (all from disk)' if zero else 'some'}; "
              f"disk hits: {svc.cache.disk_hits}")

        if args.chaos:
            print("\n== fault storm: transient errors + store bit flips ==")
            data = requests[0][0]
            expected, _ = TranslationService().translate(data)
            baseline = verified_dumps_many(loads_many(data))
            # probabilistic transients plus one request scheduled to fail
            # every attempt, so both the retry path and the degradation
            # path are on display
            plan = FaultPlan(seed=7, error_p=0.45, bit_flip_p=0.3,
                             schedule={("daemon.error", "2"): 3})
            cfg = DaemonConfig(deadline_s=10.0, backoff_s=0.001)
            with injected(plan) as inj:
                with TranslationDaemon(config=cfg) as daemon:
                    responses = drive(daemon, [(data, "translate")] * 6)
            for resp in responses:
                assert (resp.ok and resp.payload == expected) or (
                    resp.degraded and resp.payload == baseline
                ), "serving invariant violated"
            degraded = sum(r.degraded for r in responses)
            print(f"  faults fired: {dict(inj.counts())}")
            print(f"  invariant held: {len(responses) - degraded} fault-free, "
                  f"{degraded} flagged-degraded, 0 corrupt")
    finally:
        if args.store is None:
            shutil.rmtree(store_root, ignore_errors=True)


if __name__ == "__main__":
    main()
