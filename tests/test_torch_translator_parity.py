"""The port's framework-free half held against the reference's, in one process.

The port keeps its own copy of the RegDem translator (``repro_torch.core``,
``binary``, ``arch``, ``obs.stallprof``) and of the kernel corpus
(``repro_torch.data.corpus``).  Here both packages see the same inputs and
must give the same answers: byte-identical tuned containers, equal simulated
cycles and stall profiles, equal corpus profiles, and equal results from the
two packages' native simulator engines (each its own shared object, built
from its own copy of ``_sim_engine.c``).  The reference's corpus imports its
Pallas kernel file, so this file loads JAX; the port's never does
(``test_torch_imports.py``).
"""

import dataclasses
import hashlib
import os

import pytest

from repro.arch import retarget as ref_retarget
from repro.binary import dumps as ref_dumps
from repro.core import _native as ref_native
from repro.core.kernelgen import PAPER_BENCHMARKS as REF_PAPER
from repro.core.kernelgen import generate as ref_generate
from repro.core.search import SearchConfig as RefSearchConfig
from repro.core.simulator import simulate as ref_simulate
from repro.core.translator import TranslationService as RefService
from repro.data import corpus as ref_corpus
from repro_torch.arch import retarget
from repro_torch.binary import dumps
from repro_torch.core import _native
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, generate
from repro_torch.core.search import SearchConfig
from repro_torch.core.simulator import simulate
from repro_torch.core.translator import TranslationService
from repro_torch.data import corpus

ARCHS = ("maxwell", "volta")
PAPER = sorted(PAPER_BENCHMARKS)
#: the example's search (``examples/torch_serve_batched.py``) and the default
SEARCHES = {
    "example": dict(max_targets=1, beam_width=2, top_k=1),
    "default": {},
}
CORPUS_MODELS = ("gemma3_1b", "zamba2_2_7b", "mamba2_370m")


def _paper_containers(arch):
    """The nine paper kernels in one container, built by each package."""
    ref = [ref_generate(REF_PAPER[n]) for n in PAPER]
    port = [generate(PAPER_BENCHMARKS[n]) for n in PAPER]
    if arch != "maxwell":
        ref = [ref_retarget(k, arch) for k in ref]
        port = [retarget(k, arch) for k in port]
    return ref_dumps(ref), dumps(port)


def _assert_same_tune(ref_data, port_data, search):
    assert port_data == ref_data
    ref_out, ref_rep = RefService().tune(ref_data, RefSearchConfig(**SEARCHES[search]))
    out, rep = TranslationService().tune(port_data, SearchConfig(**SEARCHES[search]))
    assert out == ref_out
    assert len(rep.reports) == len(ref_rep.reports)
    for got, want in zip(rep.reports, ref_rep.reports):
        assert got.kernel_name == want.kernel_name
        assert got.chosen == want.chosen, got.kernel_name
        assert got.baseline_regs == want.baseline_regs, got.kernel_name
        assert got.search.speedup == want.search.speedup, got.kernel_name
        assert got.search.to_json() == want.search.to_json(), got.kernel_name
    return rep


@pytest.mark.parametrize("search", sorted(SEARCHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tuned_paper_container_is_byte_identical(arch, search):
    ref_data, port_data = _paper_containers(arch)
    rep = _assert_same_tune(ref_data, port_data, search)
    assert [r.kernel_name for r in rep.reports] == PAPER


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("model", CORPUS_MODELS)
def test_tuned_corpus_container_is_byte_identical(model, arch):
    rep = _assert_same_tune(ref_corpus.corpus_container(model, arch),
                            corpus.corpus_container(model, arch), "example")
    assert [r.kernel_name for r in rep.reports] == corpus.model_corpus_names(model)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", PAPER)
def test_simulated_cycles_and_stall_profile_are_equal(name, arch):
    ref_k, k = ref_generate(REF_PAPER[name]), generate(PAPER_BENCHMARKS[name])
    if arch != "maxwell":
        ref_k, k = ref_retarget(ref_k, arch), retarget(k, arch)
    want = ref_simulate(ref_k, profile=True)
    got = simulate(k, profile=True)
    for f in ("kernel_name", "cycles_per_wave", "waves", "total_cycles",
              "dynamic_instructions", "issue_stalls", "truncated"):
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.asdict(got.occupancy) == dataclasses.asdict(want.occupancy)
    assert got.stall_profile.to_json() == want.stall_profile.to_json()
    assert got.stall_profile.total == got.issue_stalls


def test_corpus_profiles_are_equal_as_dataclass_fields():
    ref = ref_corpus.corpus_profiles()
    port = corpus.corpus_profiles()
    assert list(port) == list(ref)
    assert {n: dataclasses.asdict(p) for n, p in port.items()} == {
        n: dataclasses.asdict(p) for n, p in ref.items()}
    assert [dataclasses.asdict(i) for i in corpus.kernel_instances()] == [
        dataclasses.asdict(i) for i in ref_corpus.kernel_instances()]


def test_tpu_tiler_copy_matches_the_reference_kernel_chooser():
    """The corpus's copy of the reference attention kernel's block chooser
    agrees with the original at every corpus shape and across a grid."""
    from repro.kernels.flash_attention import choose_block_sizes

    shapes = {(i.seq_q, i.seq_kv, i.dh) for i in corpus.kernel_instances() if i.kernel == "attn"}
    shapes |= {(sq, skv, dh) for sq in (1, 7, 8, 100, 1500, 4096, 32_768)
               for skv in (1, 9, 640, 1500, 32_768) for dh in (16, 64, 80, 128, 256)}
    for sq, skv, dh in sorted(shapes):
        assert corpus.tpu_attention_blocks(sq, skv, dh) == choose_block_sizes(sq, skv, dh)
    assert corpus.tpu_attention_blocks(4096, 4096, 128, vmem_budget=1 << 20) == \
        choose_block_sizes(4096, 4096, 128, vmem_budget=1 << 20)


@pytest.mark.skipif(not (ref_native.available() and _native.available()),
                    reason="no C compiler: neither native engine can be built")
def test_native_engines_are_separate_and_agree(monkeypatch):
    """Each package builds its own engine from its own copy of the C file,
    into its own shared object, and the two give equal results — native and
    pure-Python loops alike."""
    assert os.path.abspath(_native._SOURCE) != os.path.abspath(ref_native._SOURCE)
    with open(_native._SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    port_so = os.path.join(_native._cache_dir(), f"sim_engine_{digest}.so")
    ref_so = os.path.join(ref_native._cache_dir(), f"regdem_sim_{digest}.so")
    assert os.path.isfile(port_so) and os.path.isfile(ref_so) and port_so != ref_so
    for name in ("cfd", "md5hash", "nn"):
        want = ref_simulate(ref_generate(REF_PAPER[name]), profile=True)
        got = simulate(generate(PAPER_BENCHMARKS[name]), profile=True)
        assert (got.total_cycles, got.issue_stalls) == (want.total_cycles, want.issue_stalls)
        assert got.stall_profile.to_json() == want.stall_profile.to_json()
    monkeypatch.setenv("REGDEM_SIM_NATIVE", "0")
    for name in ("cfd", "md5hash"):
        py = simulate(generate(PAPER_BENCHMARKS[name]), profile=True)
        assert py.total_cycles == ref_simulate(ref_generate(REF_PAPER[name])).total_cycles
