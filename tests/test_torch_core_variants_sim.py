"""Variant generation + timing-simulator tests (paper §5.3-5.5)."""

import math

import pytest

from repro_torch.core.isa import equivalent
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, paper_kernel
from repro_torch.core.sched import verify_schedule
from repro_torch.core.simulator import flatten_trace, simulate, speedup
from repro_torch.core.variants import VARIANT_NAMES, aggressive, make_variants


@pytest.fixture(scope="module")
def cfd_variants():
    return make_variants(PAPER_BENCHMARKS["cfd"])


def test_all_variants_present(cfd_variants):
    assert set(cfd_variants) == set(VARIANT_NAMES)


def test_variants_semantics_and_schedules(cfd_variants):
    base = cfd_variants["nvcc"].kernel
    for name, v in cfd_variants.items():
        assert equivalent(base, v.kernel), name
        assert verify_schedule(v.kernel) == [], name


def test_local_variant_spills_to_local_memory(cfd_variants):
    ops = {i.op for i in cfd_variants["local"].kernel.instructions()}
    assert "LDL" in ops and "STL" in ops
    assert cfd_variants["local"].spilled > 0


def test_local_shared_variant_uses_shared(cfd_variants):
    k = cfd_variants["local-shared"].kernel
    ops = {i.op for i in k.instructions()}
    assert "LDL" not in ops and "STL" not in ops
    assert k.demoted_size > 0


def test_remat_dilates_instruction_stream(cfd_variants):
    base = len(cfd_variants["nvcc"].kernel.instructions())
    ls = cfd_variants["local-shared"]
    assert ls.remat > 0
    assert len(ls.kernel.instructions()) > base


def test_aggressive_respects_target():
    base = paper_kernel("gaussian")
    v = aggressive(base, 36, spill_space="local")
    assert v.kernel.reg_count <= 36
    assert equivalent(base, v.kernel)


# ---------------------------------------------------------------------------
# simulator behaviour
# ---------------------------------------------------------------------------


def test_trace_expands_loops():
    k = paper_kernel("conv")
    trace = flatten_trace(k)
    assert len(trace) > len(k.instructions())


def test_sim_occupancy_helps_latency_bound():
    """More resident warps must speed up a latency-bound kernel (the paper's
    core premise).  nn is chase-load bound; demotion raises occupancy."""
    vs = make_variants(PAPER_BENCHMARKS["nn"])
    s_base = simulate(vs["nvcc"].kernel)
    s_rd = simulate(vs["regdem"].kernel)
    assert s_rd.occupancy.resident_warps > s_base.occupancy.resident_warps
    assert speedup(s_base, s_rd) > 1.0


def test_sim_fp64_insensitive_to_occupancy():
    """md is FP64-throughput-bound: no variant helps (paper §5.5)."""
    vs = make_variants(PAPER_BENCHMARKS["md"])
    s = {n: simulate(v.kernel) for n, v in vs.items()}
    base = s["nvcc"]
    for n in ("regdem", "local", "local-shared"):
        assert abs(speedup(base, s[n]) - 1.0) < 0.05, n


def test_sim_regdem_beats_local_on_spill_heavy():
    """cfd needs many spills: shared-memory demotion must beat local-memory
    spilling (the paper's headline comparison)."""
    vs = make_variants(PAPER_BENCHMARKS["cfd"])
    s = {n: simulate(v.kernel) for n, v in vs.items()}
    assert s["regdem"].total_cycles < s["local"].total_cycles
    assert s["regdem"].total_cycles < s["local-shared"].total_cycles


def test_sim_geomean_reproduces_paper_band():
    """Geomean RegDem speedup must land in the paper's reported band
    (1.07x nvcc geomean; we accept 1.02-1.15 for the simulator stand-in)."""
    logs = []
    for name, prof in PAPER_BENCHMARKS.items():
        vs = make_variants(prof)
        base = simulate(vs["nvcc"].kernel)
        logs.append(math.log(speedup(base, simulate(vs["regdem"].kernel))))
    gm = math.exp(sum(logs) / len(logs))
    assert 1.02 <= gm <= 1.15, gm
