"""Round-trip and binary-pipeline tests over the kernelgen corpus.

Covers the acceptance bar: for every Table-1 kernel,
``loads(translate(dumps(k)))`` is dataflow-equivalent with a clean schedule,
and the overlay printer renders the control columns of a demoted variant.
"""

import pytest

from repro_torch.binary import dumps, loads
from repro_torch.binary.overlay import overlay, overlay_lines
from repro_torch.binary.roundtrip import check_roundtrip
from repro_torch.core.isa import equivalent
from repro_torch.core.kernelgen import (
    PAPER_BENCHMARKS,
    generate,
    paper_kernel,
    random_profile,
)
from repro_torch.core.regdem import RegDemOptions, auto_targets, demote
from repro_torch.core.sched import (
    export_ctrl_words,
    import_ctrl_words,
    verify_ctrl_words,
    verify_schedule,
)
from repro_torch.core.translator import translate, translate_binary

CORPUS = sorted(PAPER_BENCHMARKS)


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_roundtrip(name):
    check_roundtrip(paper_kernel(name))


@pytest.mark.parametrize("seed", range(8))
def test_random_kernel_roundtrip(seed):
    check_roundtrip(generate(random_profile(seed)))


@pytest.mark.parametrize("name", CORPUS)
def test_demoted_variant_roundtrip(name):
    k = paper_kernel(name)
    targets = auto_targets(k)
    if not targets:
        pytest.skip("no occupancy cliff to target")
    res = demote(k, targets[0], RegDemOptions(bank_avoid=True, reschedule=True))
    check_roundtrip(res.kernel)


@pytest.mark.parametrize("name", CORPUS)
def test_translate_binary_to_binary(name):
    """Acceptance: loads(translate(dumps(k))) is equivalent + schedule-clean."""
    k = paper_kernel(name)
    out = translate(dumps(k), options=[RegDemOptions()])
    assert isinstance(out, bytes)
    chosen = loads(out)
    assert equivalent(k, chosen)
    assert verify_schedule(chosen) == []


def test_translate_binary_report_matches_kernel_path():
    k = paper_kernel("md5hash")
    out, report = translate_binary(dumps(k))
    rep2 = translate(k)
    assert report.chosen == rep2.chosen
    assert report.considered == rep2.considered
    chosen = loads(out)
    expect = k if report.chosen == "nvcc" else report.chosen_kernel
    assert chosen.render() == expect.render()


def test_sched_words_travel_through_container():
    k = paper_kernel("nn")
    words = export_ctrl_words(k)
    assert verify_ctrl_words(k, words) == []
    k2 = loads(dumps(k))
    assert export_ctrl_words(k2) == words
    stripped = k.copy()
    for ins in stripped.instructions():
        ins.ctrl.stall = 0
        ins.ctrl.wait = set()
        ins.ctrl.write_bar = ins.ctrl.read_bar = None
    import_ctrl_words(stripped, words)
    assert stripped.render() == k.render()


def test_overlay_renders_demoted_variant_columns():
    """Acceptance: stall/yield/barrier columns for a demoted variant."""
    k = paper_kernel("conv")
    res = demote(k, auto_targets(k)[0])
    text = overlay(res.kernel)
    assert "ctrl=[stall Y | WR RD wait]" in text.splitlines()[0]
    body = text.splitlines()[1:]
    assert any("WR" in ln and "|" in ln for ln in body)  # write barrier set
    assert any("RD" in ln for ln in body)  # read barrier set (demoted store)
    assert any(" LDS " in ln for ln in body)  # demoted loads are visible
    # every instruction line carries an address and the packed word comment
    ins_lines = [ln for ln in body if ln.startswith("/*")]
    assert len(ins_lines) == len(res.kernel.instructions())
    assert all(ln.rstrip().endswith("*/") for ln in ins_lines)


def test_overlay_wait_mask_rendering():
    k = paper_kernel("cfd")
    lines = overlay_lines(k)
    # cfd is load-heavy: some instruction must wait on a barrier (a '1' bit)
    assert any(" | " in ln and "1" in ln.rsplit("|", 1)[1] for ln in lines)
