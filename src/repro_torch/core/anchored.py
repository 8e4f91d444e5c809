"""The anchored search cell: one (Profile, arch) tuned the way the golden
choices were made.

``tests/golden/search_choices.json`` (the nine paper kernels) and
``tests/golden/corpus_choices.json`` (the model corpus) pin, per kernel and
per architecture, the variant that :func:`repro_torch.core.search.search`
chooses when it is restricted to that one architecture and anchored on the
fixed §5.3 comparison set (:func:`~repro_torch.core.variants.make_variants_for`
plus the predictor's pick among them).  The reference package keeps this
recipe in its benchmark folder (``benchmarks/search_bench.py``); the port
keeps its own copy here, so its tests and ``chip_smoke.py`` can recompute
the pins without importing anything of the reference.

``TranslationService.tune`` with a narrow :class:`SearchConfig` (as
``examples/torch_serve_batched.py`` runs it) searches every registered
architecture and anchors nothing, so its choices are not these.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.arch import retarget
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, Profile, generate
from repro_torch.core.predictor import predict
from repro_torch.core.search import SearchConfig, search
from repro_torch.core.simcache import simulate_cached
from repro_torch.core.variants import make_variants_for

#: strategy families introduced by the registry (vs the paper's machinery)
NEW_FAMILIES = ("warp_share", "block_share", "compressed")


def chosen_family(chosen: str) -> tuple:
    """``(family, strategy_name)`` of one search-chosen label.

    ``<arch>/nvcc`` is the do-nothing baseline; ``<arch>/regdem@T:<strategy>
    :<opts>`` resolves its strategy's registry family; anything else is an
    anchored fixed-§5.3 variant (``local``, ``local-shared``, ...).
    """
    from repro_torch.core.strategies import get_strategy

    tail = chosen.split("/", 1)[1]
    if tail == "nvcc":
        return "nvcc", None
    if tail.startswith("regdem@"):
        name = tail.split(":", 1)[1].split(":", 1)[0]
        return get_strategy(name).family, name
    return "fixed", None


def tune_profile(prof: Profile, arch: str, workers: int = 0) -> Dict:
    """Search one (Profile, arch) cell, anchored on the fixed §5.3 set.

    Returns the cell's report row: the chosen label and family, the fixed
    pick, both simulated cycle counts, and the search's bookkeeping.
    """
    base = generate(prof)
    k = base if arch == "maxwell" else retarget(base, arch)
    # the fixed §5.3 pipeline: five variants, predictor picks one
    fixed = make_variants_for(k, prof.regdem_target, prof.nvcc_spills)
    fixed_kernels = {n: v.kernel for n, v in fixed.items()}
    fixed_best, _ = predict(fixed_kernels)
    fixed_cycles = simulate_cached(fixed_kernels[fixed_best]).total_cycles
    # the search, anchored on that same fixed set
    anchors = {f"{arch}/{n}": v.kernel for n, v in fixed.items() if n != "nvcc"}
    outcome = search(
        k, SearchConfig(archs=(arch,), workers=workers), extra_variants=anchors
    )
    sr = outcome.report
    best_cycles = sr.cycles[sr.chosen]
    family, _ = chosen_family(sr.chosen)
    return {
        "chosen": sr.chosen,
        "chosen_family": family,
        "fixed_best": fixed_best,
        "cycles_chosen": best_cycles,
        "cycles_fixed": fixed_cycles,
        "win": round(fixed_cycles / best_cycles, 4),
        "speedup_vs_nvcc": round(sr.speedup, 4),
        "agreement": round(sr.agreement, 4),
        "space_size": sr.space_size,
        "explored": sr.explored,
        "simulated": sr.simulated,
        "seconds": round(sr.seconds, 4),
    }


def tune_benchmark(bench: str, arch: str, workers: int = 0) -> Dict:
    """:func:`tune_profile` on one of the nine paper kernels."""
    return tune_profile(PAPER_BENCHMARKS[bench], arch, workers=workers)
