"""Strategy-registry tests (repro_torch.core.strategies).

Four layers:

* **registry API** — registration order, the duplicate-name guard, and the
  unknown-name error (must list what *is* registered);
* **compatibility shim** — the paper's ordering names resolve through the
  registry byte-identically: same candidate queues, same option labels,
  same :meth:`SearchConfig.signature` (so translation-cache keys and golden
  files survive the registry refactor), and re-tuning cached content under
  an explicit paper-strategy config runs zero pipeline passes;
* **correctness oracle** — every registered strategy's ``build`` output
  passes the full schedule check and stays dataflow-equivalent to its
  baseline, at every rung of its own target ladder;
* **golden win cell** — at least one benchmark x arch cell is won by a
  related-work family, strictly beating every paper-five anchor (the
  acceptance criterion the re-pinned golden encodes).
"""

import json
import os

import pytest

from repro_torch.core.anchored import NEW_FAMILIES, chosen_family
from repro_torch.binary import dumps
from repro_torch.core.isa import equivalent
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, generate, random_profile
from repro_torch.core.candidates import make_candidates
from repro_torch.core.passes import PIPELINE_COUNTERS, RegDemOptions
from repro_torch.core.sched import verify_schedule
from repro_torch.core.search import SearchConfig, search
from repro_torch.core.strategies import (
    PaperOptions,
    Strategy,
    StrategyHints,
    get_strategy,
    register_strategy,
    strategies,
    strategy_names,
)
from repro_torch.core.translator import TranslationService, option_space
from repro_torch.core.variants import make_variants_for

GOLDEN_PATH = os.path.join(
    os.path.dirname(__file__), "golden", "search_choices.json"
)

PAPER_NAMES = ("static", "cfg", "conflict")


# ---------------------------------------------------------------------------
# Registry API
# ---------------------------------------------------------------------------


def test_registration_order_paper_first():
    names = strategy_names()
    assert names[:3] == list(PAPER_NAMES)
    assert set(names) >= {"warp_share", "block_share", "compressed"}
    assert [s.name for s in strategies()] == names


def test_duplicate_name_guard():
    static = get_strategy("static")
    with pytest.raises(ValueError, match="already registered"):
        register_strategy(
            Strategy(
                name="static",
                doc="imposter",
                family="paper",
                options_cls=PaperOptions,
                hints=StrategyHints(),
                select=static.select,
                option_combos=static.option_combos,
                options_label=static.options_label,
                build=static.build,
                targets=static.targets,
            )
        )
    # the guard must not have clobbered the original
    assert get_strategy("static") is static


def test_unknown_strategy_error_lists_registered():
    with pytest.raises(ValueError) as exc:
        get_strategy("does-not-exist")
    msg = str(exc.value)
    assert "does-not-exist" in msg
    for name in strategy_names():
        assert name in msg


def test_families():
    for name in PAPER_NAMES:
        assert get_strategy(name).family == "paper"
    for name in NEW_FAMILIES:
        assert get_strategy(name).family == name


# ---------------------------------------------------------------------------
# Compatibility shim: paper names resolve byte-identically
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PAPER_NAMES)
def test_paper_select_matches_make_candidates(name):
    k = generate(PAPER_BENCHMARKS["cfd"])
    assert get_strategy(name).select(k) == make_candidates(k, name)


@pytest.mark.parametrize("name", PAPER_NAMES)
def test_paper_labels_match_regdem_options(name):
    strat = get_strategy(name)
    for full in (False, True):
        for combo in strat.option_combos(full):
            b, e, r, s = combo
            opts = RegDemOptions(
                candidate_strategy=name,
                bank_avoid=b,
                elim_redundant=e,
                reschedule=r,
                substitute=s,
            )
            assert strat.options_label(combo) == opts.label()


def test_signature_stability_for_explicit_paper_strategies():
    """An explicit paper-strategy tuple signs exactly as it did before the
    registry existed — translation-cache tune keys for those configs must
    not silently change."""
    cfg = SearchConfig(strategies=PAPER_NAMES, archs=("maxwell",))
    assert cfg.signature() == (
        ("static", "cfg", "conflict"),
        ("maxwell",),
        None,
        False,
        6,
        4,
        "chosen",
        False,
    )


def test_default_signature_resolves_registered_names():
    sig = SearchConfig().signature()
    assert sig[0] == tuple(strategy_names())


def test_option_space_rejects_non_paper_families():
    with pytest.raises(ValueError, match="family"):
        option_space(strategies=("warp_share",))
    with pytest.raises(ValueError, match="registered"):
        option_space(strategies=("no-such-strategy",))


def test_retune_paper_config_is_pure_cache_hit():
    """Re-tuning cached content under an explicit paper-strategy config runs
    zero pipeline passes and reproduces the container byte-for-byte."""
    blob = dumps([generate(random_profile(21))])
    svc = TranslationService()
    cfg = SearchConfig(strategies=PAPER_NAMES, archs=("maxwell",))
    out1, batch1 = svc.tune(blob, cfg)
    assert batch1.cached == [False]

    before = dict(PIPELINE_COUNTERS)
    out2, batch2 = svc.tune(blob, cfg)
    assert batch2.cached == [True]
    assert PIPELINE_COUNTERS == before  # zero pipelines, zero passes
    assert out2 == out1  # unchanged bytes => unchanged kernel CRCs


# ---------------------------------------------------------------------------
# Correctness oracle: every registered strategy, every ladder rung
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", strategy_names())
def test_strategy_build_schedule_and_dataflow(name):
    strat = get_strategy(name)
    base = generate(PAPER_BENCHMARKS["cfd"])
    if not strat.select(base):
        pytest.skip(f"{name}: no candidates on cfd")
    targets = strat.targets(base, None)
    if not targets:
        pytest.skip(f"{name}: empty target ladder on cfd")
    for combo in strat.option_combos(False):
        for tgt in targets:
            res = strat.build(base, tgt, combo, verify="none")
            tag = f"{strat.options_label(combo)}@{tgt}"
            assert verify_schedule(res.kernel) == [], tag
            assert equivalent(base, res.kernel), tag


@pytest.mark.parametrize("name", strategy_names())
def test_strategy_pipeline_prefixes(name):
    """Deterministic prefix invariant (the hypothesis sweep in
    test_core_pipeline_property.py generalizes this): at every pass boundary
    of the strategy's own pipeline, the schedule verifies and dataflow is
    preserved."""
    strat = get_strategy(name)
    base = generate(PAPER_BENCHMARKS["cfd"])
    if not strat.select(base):
        pytest.skip(f"{name}: no candidates on cfd")
    targets = strat.targets(base, 1)
    if not targets:
        pytest.skip(f"{name}: empty target ladder on cfd")

    boundaries = []
    strat.build(
        base,
        targets[0],
        strat.option_combos(False)[0],
        verify="none",
        observer=lambda p, c: boundaries.append(
            (p.name, verify_schedule(c.kernel), equivalent(base, c.kernel))
        ),
    )
    assert boundaries, "strategy pipeline ran no passes"
    for pass_name, sched_errs, equiv in boundaries:
        assert sched_errs == [], (name, pass_name, sched_errs[:2])
        assert equiv, (name, f"dataflow broken after pass {pass_name!r}")


@pytest.mark.parametrize("name", strategy_names())
def test_strategy_targets_respect_truncation(name):
    strat = get_strategy(name)
    base = generate(PAPER_BENCHMARKS["cfd"])
    full = strat.targets(base, None)
    assert strat.targets(base, 2) == full[:2]


def test_extra_strategies_in_variant_matrix():
    base = generate(PAPER_BENCHMARKS["cfd"])
    prof = PAPER_BENCHMARKS["cfd"]
    out = make_variants_for(
        base,
        prof.regdem_target,
        prof.nvcc_spills,
        extra_strategies=list(NEW_FAMILIES),
    )
    built = [n for n in NEW_FAMILIES if n in out]
    assert built, "no registry extra built on cfd"
    for name in built:
        v = out[name]
        assert v.name == name
        assert v.spilled > 0
        assert verify_schedule(v.kernel) == []
        assert equivalent(base, v.kernel)


# ---------------------------------------------------------------------------
# Golden win cell: a related-work family strictly beats the paper five
# ---------------------------------------------------------------------------


def test_golden_pins_a_new_family_win():
    with open(GOLDEN_PATH) as fh:
        golden = json.load(fh)
    new_cells = [
        (bench, arch)
        for bench, per_arch in golden.items()
        for arch, chosen in per_arch.items()
        if chosen_family(chosen)[0] in NEW_FAMILIES
    ]
    assert new_cells, "golden pins no related-work-family winner"
    assert ("cfd", "volta") in new_cells


def test_new_family_strictly_beats_every_paper_variant():
    """The cfd/volta cell: the search (anchored on the fixed §5.3 set) picks
    a related-work strategy whose simulated cycles strictly beat nvcc and
    all four paper-five variants."""
    from repro_torch.arch import retarget

    prof = PAPER_BENCHMARKS["cfd"]
    k = retarget(generate(prof), "volta")
    fixed = make_variants_for(k, prof.regdem_target, prof.nvcc_spills)
    anchors = {f"volta/{n}": v.kernel for n, v in fixed.items() if n != "nvcc"}
    outcome = search(k, SearchConfig(archs=("volta",)), extra_variants=anchors)
    sr = outcome.report
    family, strat = chosen_family(sr.chosen)
    assert family in NEW_FAMILIES, sr.chosen
    chosen_cycles = sr.cycles[sr.chosen]
    rivals = list(anchors) + [sr.baseline]
    for label in rivals:
        assert chosen_cycles < sr.cycles[label], (sr.chosen, label)
