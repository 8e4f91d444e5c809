"""Real-workload corpus tests (repro_torch.data.corpus + repro_torch.core.anchored).

Four layers:

* **extraction** — the corpus is deterministic, covers every model config
  and serving phase, and every extracted profile is generable and carries a
  real demotion target (``regdem_target < target_regs`` — the spill_targets
  32-register floor sat *above* small decode kernels until the corpus
  flushed it);
* **golden** — the extracted profiles are pinned field-for-field in
  ``tests/golden/corpus_profiles.json``; the per-cell search choices in
  ``tests/golden/corpus_choices.json`` must agree with a live recompute (a small
  deterministic slice in tier-1; every cell when ``REGDEM_PROPERTY_SCALE``
  raises the budget, as nightly CI does);
* **variants** — the flushed unlaunchable-conversion bug stays fixed:
  corpus kernels with large static shared memory drop the Hayes & Zhang
  conversions that would exceed the per-block limit instead of crashing
  downstream occupancy math;
* **tune→serve** — a model config's corpus container round-trips through
  ``TranslationService.tune`` with a persistent ArtifactStore: the warm
  restart runs zero pipeline passes and returns byte-identical output.
"""

import dataclasses
import json
import os

import pytest

from repro_torch.core.kernelgen import generate
from repro_torch.core.search import SearchConfig
from repro_torch.data.corpus import (
    CORPUS_BENCHMARKS,
    corpus_container,
    corpus_profiles,
    kernel_instances,
    model_corpus_names,
)

SCALE = max(1, int(os.environ.get("REGDEM_PROPERTY_SCALE", "1")))

GOLDEN_PROFILES = os.path.join(
    os.path.dirname(__file__), "golden", "corpus_profiles.json"
)
GOLDEN_CHOICES = os.path.join(
    os.path.dirname(__file__), "golden", "corpus_choices.json"
)

#: tier-1 live-recompute slice: one cell per kernel kind x phase x arch
#: regime (prefill/decode, attn/ssd, small/large registers)
TIER1_RECOMPUTE = [
    "gemma3_1b.prefill.attn",
    "gemma3_1b.decode.attn",
    "mamba2_370m.prefill.ssd",
    "zamba2_2_7b.decode.ssd",
]


@pytest.fixture(scope="module")
def golden_profiles():
    with open(GOLDEN_PROFILES) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def golden_choices():
    with open(GOLDEN_CHOICES) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------


def test_corpus_covers_every_model_and_phase():
    from repro_torch.configs.base import ARCH_IDS

    models = {n.split(".")[0] for n in CORPUS_BENCHMARKS}
    assert models == set(ARCH_IDS)
    for model in ARCH_IDS:
        phases = {n.split(".")[1] for n in model_corpus_names(model)}
        assert phases == {"prefill", "decode"}, model
    # hybrid configs contribute both kernel kinds
    assert "zamba2_2_7b.prefill.attn" in CORPUS_BENCHMARKS
    assert "zamba2_2_7b.prefill.ssd" in CORPUS_BENCHMARKS


def test_corpus_extraction_is_deterministic():
    assert corpus_profiles() == corpus_profiles()
    assert [i.name for i in kernel_instances()] == list(CORPUS_BENCHMARKS)


def test_every_corpus_profile_generates_with_real_demotion_target():
    """Regression (corpus-flushed): spill_targets floors at 32 registers,
    which sits *above* a small decode kernel's register count — the
    extraction must never emit regdem_target >= target_regs."""
    for name, prof in CORPUS_BENCHMARKS.items():
        k = generate(prof)
        assert k.reg_count <= prof.target_regs + 2, name
        assert prof.regdem_target < prof.target_regs, name
        assert prof.n_state >= 2, name


def test_model_corpus_names_unknown_model():
    with pytest.raises(KeyError):
        model_corpus_names("not_a_model")


# ---------------------------------------------------------------------------
# golden pins
# ---------------------------------------------------------------------------


def test_golden_profiles_match_extraction(golden_profiles):
    """Field-for-field pin: any extraction drift must be a deliberate
    golden regeneration, never an accident."""
    live = {n: dataclasses.asdict(p) for n, p in CORPUS_BENCHMARKS.items()}
    assert live == golden_profiles


def test_golden_corpus_choices_recompute(golden_choices):
    """Live search recompute matches the pins.  Tier-1 runs a fixed slice
    of regimes; the nightly scale sweep recomputes every cell."""
    from repro_torch.core.anchored import tune_profile

    names = list(golden_choices) if SCALE > 1 else TIER1_RECOMPUTE
    for name in names:
        for arch, chosen in golden_choices[name].items():
            row = tune_profile(CORPUS_BENCHMARKS[name], arch)
            assert row["chosen"] == chosen, f"{name}/{arch}"
            assert row["cycles_chosen"] <= row["cycles_fixed"], f"{name}/{arch}"


# ---------------------------------------------------------------------------
# variants: the unlaunchable-conversion regression
# ---------------------------------------------------------------------------


def test_unlaunchable_local_shared_dropped_not_crashing():
    """Regression (corpus-flushed): gemma3_1b.prefill.attn carries 24 KiB
    static shared memory x 256 threads — converting its spills to shared
    at the 32-register floor exceeds Maxwell's 48 KiB block limit.  The
    fixed §5.3 set must drop that unlaunchable conversion (as a real launch
    failure would) and the predictor must rank the remainder, not raise."""
    from repro_torch.core.predictor import predict
    from repro_torch.core.spillspace import spill_limit
    from repro_torch.core.variants import make_variants_for

    prof = CORPUS_BENCHMARKS["gemma3_1b.prefill.attn"]
    k = generate(prof)
    fixed = make_variants_for(k, prof.regdem_target, prof.nvcc_spills)
    assert "local-shared" not in fixed          # would not fit -> not launchable
    assert "local-shared-relax" in fixed        # fits at the relaxed target
    for v in fixed.values():
        assert v.kernel.total_shared <= spill_limit(v.kernel), v.name
    best, _ = predict({n: v.kernel for n, v in fixed.items()})
    assert best in fixed


def test_small_kernels_keep_all_five_variants():
    """The drop is surgical: kernels whose conversions fit keep the full
    §5.3 matrix (the synthetic nine and small-smem corpus kernels)."""
    from repro_torch.core.variants import VARIANT_NAMES, make_variants_for

    prof = CORPUS_BENCHMARKS["whisper_large_v3.decode.attn"]
    k = generate(prof)
    fixed = make_variants_for(k, prof.regdem_target, prof.nvcc_spills)
    assert set(fixed) == set(VARIANT_NAMES)


# ---------------------------------------------------------------------------
# tune -> serve round trip
# ---------------------------------------------------------------------------


def test_corpus_tune_serve_warm_restart_zero_passes(tmp_path):
    """A model config's corpus container tunes once, then a *fresh* service
    over the same store serves it with zero pipeline passes, byte-identical
    (the serve_batched.py end-to-end invariant)."""
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.core.passes import PIPELINE_COUNTERS
    from repro_torch.core.translator import TranslationService

    cfg = SearchConfig(max_targets=1, beam_width=2, top_k=1)
    data = corpus_container("whisper_large_v3")
    first, rep1 = TranslationService(store=ArtifactStore(str(tmp_path))).tune(
        data, cfg
    )
    assert rep1.cache_misses == len(model_corpus_names("whisper_large_v3"))

    svc = TranslationService(store=ArtifactStore(str(tmp_path)))
    before = dict(PIPELINE_COUNTERS)
    again, rep2 = svc.tune(data, cfg)
    after = dict(PIPELINE_COUNTERS)
    assert again == first
    assert rep2.cache_misses == 0 and rep2.hit_rate == 1.0
    assert after["passes"] == before["passes"]
    assert after["pipelines"] == before["pipelines"]
    assert svc.cache.disk_hits == len(rep2.reports)


def test_corpus_container_reports_embed_search_notes(tmp_path):
    """Tuned corpus containers carry their per-kernel search reports as
    .note sections, recoverable by name."""
    from repro_torch.binary import read_notes
    from repro_torch.core.translator import TranslationService

    cfg = SearchConfig(max_targets=1, beam_width=2, top_k=1)
    tuned, rep = TranslationService().tune(corpus_container("stablelm_3b"), cfg)
    notes = read_notes(tuned)
    for i, r in enumerate(rep.reports):
        key = f"search.{i}.{r.kernel_name}"
        assert key in notes
        payload = json.loads(notes[key])
        assert payload["chosen"] == r.search.chosen
