"""Reads the numbers that ``correct`` compares, over many seeds in one
process, for the program and for its controls: the readings that each
cell's limits are set from (``PERF.md`` gives them).

    python3 gpubench/calibrate.py --workload <cell> --first-seed <n> --seeds 12 \
        --controls 3 --seconds 1 [--out FILE] [--rehearse]

Serving: one Server, set up once and warmed as a run warms it; for each
seed the weights are drawn again into the tensors it adopted, a window of
``--seconds`` is served from the seed's traffic (at least one call, so the
cell's whole load), and the sample is compared with the float32 reference
(``logit_gap``); on the first ``--controls`` seeds the control, the
reference computed in float8 (``control_gap``: the gap of the token it puts
first at each position).  Training: for each seed the set-up's steps and
the reference's; on the first ``--controls`` seeds also the float8 control
and a planted fault (half of each row's targets left out) against the
float32 reference.  One JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worst(got, want):
    """The leaf farthest from the reference, with its two norms."""
    import statistics

    med = statistics.median(want.values())
    k = max(want, key=lambda k: abs(got[k] - want[k]) / max(want[k], med))
    return [k, got[k], want[k], med]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    import torch

    from gpubench import harness, trace
    from gpubench.reference import no_tf32
    from gpubench.traffic import lengths

    no_tf32()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    run = harness.open_run(ROOT, args.workload, seeds[0], False, args.rehearse)
    run.device = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    kind = run.workload["kind"]
    if kind == "train":
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            run.seed, run.record = seed, {}
            drv = harness.driver(run)
            drv.setup()
            drv.release()
            want = drv.reference()
            row = {"seed": seed, "program": drv.compare(run.record, want),
                   "losses": run.record["losses"], "ref_losses": want["losses"],
                   "worst_change": worst(run.record["change"], want["change"]),
                   "worst_grad": worst(run.record["first_grad"], want["first_grad"])}
            if i < args.controls:
                row["control"] = drv.compare(drv.reference("fp8"), want)
                row["fault_half_targets"] = drv.compare(drv.reference(drop_half=True), want)
            row["seconds"] = time.perf_counter() - t0
            emit(row)
        return 0

    drv = harness.driver(run)
    drv.setup()
    tracer = trace.Tracer(False, cuda=False)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        run.seed, run.record = seed, {}
        drv.calls = []
        with torch.no_grad():
            for j, (name, (shape, std)) in enumerate(drv.ref.layout(run.dims).items()):
                w = drv.weights[name]
                w.copy_(harness.draw_leaf(shape, std, seed, j, w.device, w.dtype))
        drv.lengths = lengths.Lengths(drv.pool, seed)
        drv.tokens = lengths.rng(seed, 2)
        drv.window(args.seconds, tracer)
        got = drv.readings("fp8" if i < args.controls else "fp32", weights=drv.weights)
        attempted, failed = drv.counts()
        emit({"seed": seed, **got, "attempted": attempted, "failed": failed,
              "window_s": run.record["window_s"], "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
