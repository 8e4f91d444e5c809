"""End-to-end behaviour tests: the full pyReDe translation pipeline."""


from repro_torch.core.isa import equivalent
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, paper_kernel
from repro_torch.core.occupancy import occupancy_of
from repro_torch.core.postopt import eliminate_redundant
from repro_torch.core.regdem import RegDemOptions, demote
from repro_torch.core.sched import verify_schedule
from repro_torch.core.translator import option_space, roundtrip, translate


def test_translate_pipeline_end_to_end():
    k = paper_kernel("conv")
    rep = translate(k)
    assert rep.chosen != "nvcc"  # conv benefits from demotion
    chosen = rep.chosen_kernel
    assert equivalent(k, chosen)
    assert verify_schedule(chosen) == []
    assert occupancy_of(chosen).occupancy > occupancy_of(k).occupancy
    # re-emission (the MaxAs step) is stable
    roundtrip(chosen)


def test_translate_explicit_target():
    k = paper_kernel("cfd")
    rep = translate(k, target_regs=56)
    assert all("@56" in n for n in rep.results)


def test_option_space_sizes():
    assert len(option_space()) == 12
    assert len(option_space(full=True)) == 48


def test_translate_considers_baseline():
    k = paper_kernel("gaussian")
    rep = translate(k)
    assert "nvcc" in rep.considered
    # predictions cover every considered variant
    assert set(rep.predictions) == set(rep.considered)


def test_postopt_passes_reduce_demote_traffic():
    k = paper_kernel("pc")
    res = demote(
        k,
        PAPER_BENCHMARKS["pc"].regdem_target,
        RegDemOptions(elim_redundant=False, reschedule=False, substitute=False),
    )
    raw = res.kernel
    n_before = sum(1 for i in raw.instructions() if i.tag == "demoted_load")
    removed = eliminate_redundant(raw, res.rdv)
    n_after = sum(1 for i in raw.instructions() if i.tag == "demoted_load")
    assert removed >= 0 and n_after <= n_before
    assert equivalent(k, raw)
    assert verify_schedule(raw) == []


def test_demotion_improves_occupancy_on_all_benchmarks():
    """Paper Table 1: RegDem improves occupancy on every benchmark."""
    for name, prof in PAPER_BENCHMARKS.items():
        k = paper_kernel(name)
        res = demote(k, prof.regdem_target)
        assert occupancy_of(res.kernel).occupancy > occupancy_of(k).occupancy, name
