"""Runs one cell of the port's benchmark once, in this process.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, ``gpubench/`` and
the program (``src/repro_torch``), on a machine with the cards the cell asks
for.  Set-up (imports, weights drawn on the card from the seed, kernels
built or loaded, the cell's own shapes warmed) counts as ``setup_s``; then
the window measures for ``--seconds``; then the program's state is freed and
what its timed path produced is checked against the plain float32 reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also close standard error.

``--rehearse`` runs the cell on the CPU at its configuration's rehearsal
sizes with the kernels' plain paths; it prints the same line with every
clock and trace metric marked as not measured (a CPU run measures no
device).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the build and kernel caches: fixed directories inside the checkout, so
#: that only a cell's first run there builds
CACHES = {"TRITON_CACHE_DIR": "build/gpubench/triton",
          "TORCH_EXTENSIONS_DIR": "build/gpubench/torch_extensions",
          "REPRO_TORCH_BUILD_DIR": "build/repro_torch"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at the rehearsal sizes; no device metric is measured")
    args = ap.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))

    import torch

    from gpubench import harness
    from gpubench.trace import Tracer, phase_rates

    run = harness.open_run(ROOT, args.workload, args.seed, bool(args.trace), args.rehearse)
    chips = run.cell["chips"]
    if args.rehearse:
        run.device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"gpubench: {args.workload} needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
        run.device = torch.device("cuda", 0)
        torch.cuda.reset_peak_memory_stats()
    import repro_torch

    if Path(repro_torch.__file__).resolve().parents[2] != ROOT:
        print(f"gpubench: the program was not found in this checkout ({repro_torch.__file__})",
              file=sys.stderr)
        return 2

    drv = harness.driver(run)
    run.record["setup_parts"] = {"imports_s": time.perf_counter() - T0}
    drv.setup()
    run.record["setup_s"] = time.perf_counter() - T0
    tracer = Tracer(run.traced, cuda=run.device.type == "cuda", seconds=args.seconds)
    drv.window(args.seconds, tracer)
    tracer.end()
    run.trace = tracer.data
    run.record["trace_read_s"] = tracer.read_s
    peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else None
    attempted, failed = drv.counts()
    e2e = drv.end_to_end()
    drv.release()
    checks = drv.check()
    loaded = harness.banned_modules()
    if loaded:
        print(f"gpubench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3

    # a CPU rehearsal measures no device: its clock and trace readings are
    # marked as not measured, and only the program's counters are read
    section = "per_layer" if run.traced else "end_to_end"
    if not run.traced:
        e2e["setup_s"] = run.record["setup_s"]
        e2e["peak_memory_gib"] = peak / (1 << 30) if peak is not None else None
    out_metrics = {}
    for m in run.metrics(section):
        name = m["name"]
        if args.rehearse and m["source"] in ("device_trace", "host_clock"):
            out_metrics[name] = {"value": None, "unit": m["unit"], "not_measured": "cpu rehearsal"}
            continue
        if run.traced:
            value = harness.reader(name)(run)
        elif name in e2e:
            value = e2e[name]
        else:
            print(f"gpubench: the driver gave no {name}", file=sys.stderr)
            return 3
        if value is not None:
            out_metrics[name] = {"value": value, "unit": m["unit"]}
        elif args.rehearse:   # a counter that exists only on the card
            out_metrics[name] = {"value": None, "unit": m["unit"], "not_measured": "cpu rehearsal"}
        # on the card, a reader that found nothing leaves its metric out

    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    if args.rehearse:
        device = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0, "memory_peak_bytes": None}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                  "memory_peak_bytes": peak}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": device}
    if run.traced and run.trace is not None and not args.rehearse:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}

    info = {k: v for k, v in run.record.items()
            if k in ("setup_s", "setup_parts", "window_s", "steps", "decode_replays",
                     "latency_ms", "tokens_compared", "losses", "window_losses", "loss_gap",
                     "trace_read_s")}
    if run.traced:   # the recorded calls' rate against the others': the profiler's cost
        info["trace_phases"] = phase_rates(run.record["calls"])
    info["requests"] = len(run.record.get("served", []))
    info["power_limit"] = power_limit() if not args.rehearse else None
    print("gpubench.info " + json.dumps(info))
    print(json.dumps(result))
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    return 0


def power_limit():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


if __name__ == "__main__":
    sys.exit(main())
