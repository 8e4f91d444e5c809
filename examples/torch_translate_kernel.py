"""pyReDe walkthrough: translate a register-pressure-bound GPU kernel.

Shows the paper's full pipeline on one benchmark: occupancy diagnosis,
automatic spill-target choice, demotion, and predictor-based variant
selection — then verifies the translated binary on the ISA interpreter and
grades it on the timing simulator.

The counterpart of ``examples/translate_kernel.py`` over ``repro_torch``
alone: for the same arguments it prints what the reference prints, byte for
byte.  The translator is host code and the example makes no tensor, so it
takes no ``--device``.

    PYTHONPATH=src python examples/torch_translate_kernel.py --kernel cfd

The pipeline is binary->binary: the kernel is serialized to pseudo-cubin
container bytes, translated bytes-in/bytes-out, and disassembled again.
``--overlay`` prints the chosen variant as SASSOverlay-style annotated
disassembly (stall / yield / barrier columns).

``--batch`` exercises the multi-kernel service instead: it packs several
benchmark kernels (plus a duplicate) into ONE v2 container, translates it in
one call, and prints per-kernel outcomes and the translation-cache hit rate:

    PYTHONPATH=src python examples/torch_translate_kernel.py --batch cfd,nn,cfd

``--tune`` replaces the fixed variant set with the predictor-guided
autotuning search (every candidate strategy x the full spill-target ladder x
option knobs x every registered architecture), fanning out over ``--workers``
processes; the per-kernel search report comes back as a ``.note`` section of
the emitted container:

    PYTHONPATH=src python examples/torch_translate_kernel.py --kernel cfd --tune
    PYTHONPATH=src python examples/torch_translate_kernel.py --batch cfd,nn,cfd --tune --workers 4

``--profile`` grades the chosen variant with stall attribution turned on and
prints the profiled overlay — every instruction line gains an attributed
stall-cycle column (cycles, share of total, dominant reason).  With
``--tune`` the search itself runs profiled, so every confirmed variant's
stall profile lands in the search report.  ``--trace out.json`` records
telemetry spans for the whole walkthrough and writes a Chrome trace
(chrome://tracing / Perfetto); ``--trace out.jsonl`` writes the JSONL event
log instead:

    PYTHONPATH=src python examples/torch_translate_kernel.py --kernel cfd --profile
    PYTHONPATH=src python examples/torch_translate_kernel.py --kernel cfd --tune --trace trace.json
"""

import argparse
import json
import sys

from repro_torch import obs
from repro_torch.binary import dumps, kernel_names, loads, loads_many, overlay, read_notes
from repro_torch.core import SearchConfig, TranslationService, occupancy_of, translate_binary
from repro_torch.core.isa import equivalent
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, paper_kernel
from repro_torch.core.regdem import auto_targets
from repro_torch.core.simulator import simulate, speedup


def run_batch(names, tune=False, workers=0) -> None:
    """Pack the named kernels into one multi-kernel container and translate
    (or autotune) the whole batch in a single call."""
    kernels = [paper_kernel(n) for n in names]
    blob = dumps(kernels)
    print(f"batch: {len(kernels)} kernels {names} in one {len(blob)}B container "
          f"({kernel_names(blob)})")
    service = TranslationService()
    if tune:
        out, report = service.tune(blob, SearchConfig(workers=workers))
    else:
        out, report = service.translate(blob)
    translated = loads_many(out)
    for orig, dec, rep, hit in zip(kernels, translated, report.reports, report.cached):
        src = "cache" if hit else f"{len(rep.considered)} variants"
        print(f"  {orig.name:10s} {orig.reg_count:3d} -> {dec.reg_count:3d} regs "
              f"({dec.arch}), chose {rep.chosen} ({src})")
        assert equivalent(orig, dec), "translation must preserve semantics"
    if tune:
        for name, payload in sorted(read_notes(out).items()):
            r = json.loads(payload)
            print(f"  note {name}: explored {r['explored']}/{r['space_size']}, "
                  f"simulated {r['simulated']}, speedup {r['speedup']:.3f}x, "
                  f"agreement {r['agreement']:.2f}")
    print(f"one call: {len(blob)}B in, {len(out)}B out; cache "
          f"{report.cache_hits} hits / {report.cache_misses} misses "
          f"(hit rate {report.hit_rate:.2f})")
    print("OK")


def run_tune(name, workers=0, overlay_out=False, profile=False) -> None:
    """Autotune one kernel binary->binary and walk through the search report."""
    k = paper_kernel(name)
    occ = occupancy_of(k)
    print(f"kernel {k.name}: {k.reg_count} regs, occupancy {occ.occupancy:.3f} "
          f"(limited by {occ.limiter}); spill-target ladder {auto_targets(k)}")
    blob = dumps(k)
    cfg = SearchConfig(workers=workers, profile=profile)
    out, report = translate_binary(blob, tune=True, search_config=cfg)
    sr = report.search
    print(f"searched {sr.space_size} configurations: explored {sr.explored} "
          f"demotions, beam {len(sr.beam)}, simulated {sr.simulated}")
    print(f"predictor choice: {sr.predictor_choice}; confirmed winner: {sr.chosen} "
          f"({sr.speedup:.3f}x over its arch's nvcc baseline, "
          f"agreement {sr.agreement:.2f})")
    for arch, best in sorted(sr.per_arch.items()):
        print(f"  best on {arch:8s}: {best} ({sr.cycles[best]} cycles)")
    chosen = loads(out)
    assert equivalent(k, chosen), "tuned kernel must preserve semantics"
    print(f"binary->binary: {len(blob)}B in, {len(out)}B out "
          f"(+{len(read_notes(out))} search-report note)")
    if profile:
        for label, prof in sorted(sr.stall_profiles.items()):
            top = prof.hot(1)
            hot = (f"hottest #{top[0].index} {top[0].op} "
                   f"({prof.share(top[0]):.0%} {top[0].top_reason})"
                   if top else "no attributed stalls")
            print(f"  profile {label:28s} {prof.total:6d} stall cycles, {hot}")
        if sr.chosen in sr.stall_profiles:
            print(overlay(chosen, profile=sr.stall_profiles[sr.chosen]))
    elif overlay_out:
        print(overlay(chosen))
    print("OK")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="cfd", choices=sorted(PAPER_BENCHMARKS))
    ap.add_argument("--overlay", action="store_true",
                    help="print annotated disassembly of the chosen variant")
    ap.add_argument("--batch", nargs="?", const="cfd,nn,md5hash,cfd", default=None,
                    metavar="K1,K2,...",
                    help="translate several kernels as one multi-kernel "
                         "container (default batch repeats cfd to show the "
                         "translation cache)")
    ap.add_argument("--tune", action="store_true",
                    help="autotune with the predictor-guided search instead "
                         "of the fixed variant set")
    ap.add_argument("--workers", type=int, default=0, metavar="N",
                    help="search process-pool size (default: in-process; "
                         "results are identical for any pool size)")
    ap.add_argument("--profile", action="store_true",
                    help="attribute stall cycles per instruction and print "
                         "the profiled overlay (with --tune: profile every "
                         "confirmed search variant)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record telemetry for the whole run and write a "
                         "Chrome trace (.json) or JSONL event log (.jsonl)")
    args = ap.parse_args()

    if args.trace:
        obs.enable()
    try:
        _run(ap, args)
    finally:
        if args.trace:
            fmt = obs.write_trace(args.trace)
            spans = obs.get_telemetry().event_count()
            print(f"trace: {spans} spans -> {args.trace} ({fmt})",
                  file=sys.stderr)


def _run(ap, args) -> None:
    if args.batch:
        names = [n.strip() for n in args.batch.split(",") if n.strip()]
        bad = [n for n in names if n not in PAPER_BENCHMARKS]
        if bad or not names:
            ap.error(f"--batch: invalid kernel name(s) {bad or args.batch!r} "
                     f"(choose from {', '.join(sorted(PAPER_BENCHMARKS))})")
        run_batch(names, tune=args.tune, workers=args.workers)
        return

    if args.tune:
        run_tune(args.kernel, workers=args.workers, overlay_out=args.overlay,
                 profile=args.profile)
        return

    k = paper_kernel(args.kernel)
    occ = occupancy_of(k)
    print(f"kernel {k.name}: {k.reg_count} regs, {k.threads_per_block} thr/block, "
          f"occupancy {occ.occupancy:.3f} (limited by {occ.limiter})")
    print(f"occupancy-cliff spill targets: {auto_targets(k)}")

    # the shipping path: container bytes in, container bytes out
    blob = dumps(k)
    out, report = translate_binary(blob)
    chosen = loads(out)
    print(f"considered {len(report.considered)} variants; predictor chose: {report.chosen}")
    print(f"binary->binary: {len(blob)}B container in, {len(out)}B container out")
    if report.chosen != "nvcc":
        occ2 = occupancy_of(chosen)
        print(f"  regs {k.reg_count} -> {chosen.reg_count}, "
              f"occupancy {occ.occupancy:.3f} -> {occ2.occupancy:.3f}, "
              f"+{chosen.demoted_size}B shared for demoted registers")
        assert equivalent(k, chosen), "translation must preserve semantics"
        s = speedup(simulate(k), simulate(chosen))
        print(f"  simulated speedup over baseline: {s:.3f}x")
    if args.profile:
        prof = simulate(chosen, profile=True).stall_profile
        print(f"stall attribution: {prof.total} cycles across "
              f"{len(prof.instructions)} instructions")
        print(overlay(chosen, profile=prof))
    elif args.overlay:
        print(overlay(chosen))
    print("OK")


if __name__ == "__main__":
    main()
