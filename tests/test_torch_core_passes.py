"""Pass-pipeline tests: prefix invariants (hypothesis), Table-3 regression
golden values, spill spaces, per-pass diagnostics, and self-check teeth."""

import pytest

from repro_torch.core.isa import RZ, Instr, equivalent
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, paper_kernel
from repro_torch.core.passes import (
    PIPELINE_COUNTERS,
    Pass,
    PassContext,
    PassPipeline,
    PassVerificationError,
    RegDemOptions,
    aggressive_pipeline,
    demotion_pipeline,
)
from repro_torch.core.regdem import REG_FLOOR, demote
from repro_torch.core.sched import verify_schedule
from repro_torch.core.spillspace import SMEM_LIMIT, LocalSpace, SharedSpace, spill_space
from repro_torch.core.variants import aggressive, make_variants

# ---------------------------------------------------------------------------
# Regression: the refactored pipeline reproduces the pre-refactor Table-3
# variant register counts, spilled/demoted word counts, and remat counts
# (captured from the hard-wired demote()/aggressive() implementations).
# ---------------------------------------------------------------------------

# {benchmark: {variant: (reg_count, spilled_words, remat_count)}}
GOLDEN_TABLE3 = {
    "cfd": {"nvcc": (68, 0, 0), "regdem": (56, 14, 0), "local": (56, 11, 2),
            "local-shared": (38, 18, 15), "local-shared-relax": (56, 12, 2)},
    "qtc": {"nvcc": (55, 0, 0), "regdem": (48, 9, 0), "local": (48, 8, 0),
            "local-shared": (32, 14, 12), "local-shared-relax": (48, 9, 0)},
    "md5hash": {"nvcc": (33, 0, 0), "regdem": (32, 3, 0), "local": (32, 0, 1),
                "local-shared": (32, 0, 3), "local-shared-relax": (32, 2, 1)},
    "md": {"nvcc": (34, 0, 0), "regdem": (32, 4, 0), "local": (32, 2, 1),
           "local-shared": (32, 0, 4), "local-shared-relax": (32, 3, 1)},
    "gaussian": {"nvcc": (43, 0, 0), "regdem": (40, 5, 0), "local": (40, 2, 2),
                 "local-shared": (32, 1, 13), "local-shared-relax": (40, 3, 2)},
    "conv": {"nvcc": (35, 0, 0), "regdem": (32, 5, 0), "local": (32, 2, 3),
             "local-shared": (32, 0, 6), "local-shared-relax": (32, 3, 3)},
    "nn": {"nvcc": (35, 0, 0), "regdem": (32, 5, 0), "local": (32, 2, 3),
           "local-shared": (32, 0, 6), "local-shared-relax": (32, 3, 3)},
    "pc": {"nvcc": (36, 0, 0), "regdem": (32, 6, 0), "local": (32, 3, 2),
           "local-shared": (32, 0, 7), "local-shared-relax": (32, 4, 2)},
    "vp": {"nvcc": (34, 0, 0), "regdem": (32, 4, 0), "local": (32, 2, 2),
           "local-shared": (32, 0, 5), "local-shared-relax": (32, 3, 2)},
}


@pytest.mark.parametrize("name", sorted(GOLDEN_TABLE3))
def test_refactor_reproduces_table3_golden(name):
    vs = make_variants(PAPER_BENCHMARKS[name])
    for vname, (regs, spilled, remat) in GOLDEN_TABLE3[name].items():
        v = vs[vname]
        assert v.kernel.reg_count == regs, (name, vname)
        assert v.spilled == spilled, (name, vname)
        assert v.remat == remat, (name, vname)
    assert vs["regdem"].regdem.demoted_words == GOLDEN_TABLE3[name]["regdem"][1]


# ---------------------------------------------------------------------------
# Pipeline prefixes preserve the core invariants (fixed-seed smoke version;
# the hypothesis-driven sweep lives in test_core_pipeline_property.py)
# ---------------------------------------------------------------------------


def _check_prefixes(original, pipeline, ctx):
    boundaries = []
    pipeline.run(
        ctx,
        observer=lambda p, c: boundaries.append(
            (p.name, verify_schedule(c.kernel), equivalent(original, c.kernel))
        ),
    )
    assert boundaries, "pipeline ran no passes"
    for pass_name, sched_errs, equiv in boundaries:
        assert sched_errs == [], (pass_name, sched_errs[:2])
        assert equiv, f"dataflow broken after pass {pass_name!r}"


@pytest.mark.parametrize("name", ["cfd", "pc", "nn"])
def test_demotion_pipeline_prefixes_preserve_invariants(name):
    """After *every* pass boundary of the demotion pipeline — not just the
    end — the kernel is dataflow-equivalent to the original and the schedule
    verifies clean."""
    k = paper_kernel(name)
    opt = RegDemOptions()
    ctx = PassContext(k, SharedSpace(), opt, target=PAPER_BENCHMARKS[name].regdem_target)
    _check_prefixes(k, demotion_pipeline(opt, verify="none"), ctx)


@pytest.mark.parametrize("space_name", ["local", "shared"])
def test_aggressive_pipeline_prefixes_preserve_invariants(space_name):
    k = paper_kernel("gaussian")
    space = LocalSpace() if space_name == "local" else SharedSpace(check_limit=False)
    opt = RegDemOptions(candidate_strategy="static", bank_avoid=False,
                        elim_redundant=False, reschedule=False, substitute=False)
    ctx = PassContext(k, space, opt, target=32, floor=32)
    _check_prefixes(k, aggressive_pipeline(verify="none"), ctx)


# ---------------------------------------------------------------------------
# Spill spaces
# ---------------------------------------------------------------------------


def test_spill_space_lookup():
    assert isinstance(spill_space("shared"), SharedSpace)
    assert isinstance(spill_space("local"), LocalSpace)
    with pytest.raises(ValueError):
        spill_space("global")


def test_shared_space_offsets_follow_eq1():
    k = paper_kernel("nn")
    ctx = PassContext(k, SharedSpace(), target=32)
    n = k.threads_per_block
    s_up = (k.shared_size + 3) // 4 * 4
    assert ctx.space.offsets(ctx, 2) == [s_up, s_up + n * 4]
    ctx.demoted_words = 3
    assert ctx.space.offsets(ctx, 1) == [s_up + 3 * n * 4]


def test_local_space_offsets_are_per_thread_slots():
    k = paper_kernel("nn")
    ctx = PassContext(k, LocalSpace(), target=32)
    ctx.demoted_words = 2
    assert ctx.space.offsets(ctx, 2) == [8, 12]
    assert not ctx.space.needs_base
    assert ctx.space.emit_prologue(ctx) == 0  # no base register, no prologue


def test_shared_space_limit_enforced():
    k = paper_kernel("nn")
    ctx = PassContext(k, SharedSpace(check_limit=True), target=32)
    ctx.demoted_words = (SMEM_LIMIT // (k.threads_per_block * 4)) + 1
    with pytest.raises(ValueError, match="shared memory limit"):
        ctx.space.account(ctx)
    relaxed = PassContext(k, SharedSpace(check_limit=False), target=32)
    relaxed.demoted_words = ctx.demoted_words
    relaxed.space.account(relaxed)  # conversion variants historically do not guard


# ---------------------------------------------------------------------------
# Diagnostics, prologue semantics, and the pipeline's teeth
# ---------------------------------------------------------------------------


def test_demote_surfaces_per_pass_stats():
    k = paper_kernel("pc")
    res = demote(k, PAPER_BENCHMARKS["pc"].regdem_target)
    names = [p.name for p in res.passes]
    assert names == ["reserve", "prologue", "demote", "eliminate_redundant",
                     "compact", "substitute", "reschedule", "fixup_stalls"]
    stats = res.pass_stats()
    assert stats["demote"]["demoted_words"] == res.demoted_words
    assert stats["prologue"]["inserted"] == 2
    assert stats["compact"]["reg_count"] == res.kernel.reg_count
    assert all(p.seconds >= 0.0 for p in res.passes)


def test_options_gate_pipeline_passes():
    opt = RegDemOptions(elim_redundant=False, reschedule=False, substitute=False)
    names = [p.name for p in demotion_pipeline(opt).passes]
    assert "eliminate_redundant" not in names
    assert "reschedule" not in names
    assert "substitute" not in names
    assert names == ["reserve", "prologue", "demote", "compact", "fixup_stalls"]


def test_aggressive_prologue_uses_barrier_tracker():
    """Satellite fix: the shared-space prologue of aggressive() carries
    tracker-assigned barriers (S2R signals a write barrier, SHL waits on
    it), matching demote()'s prologue semantics instead of the old
    hard-coded write_bar=0/stall=15."""
    base = paper_kernel("gaussian")
    v = aggressive(base, REG_FLOOR, spill_space="shared")
    s2r, shl = v.kernel.instructions()[:2]
    assert s2r.op == "S2R" and shl.op == "SHL"
    assert s2r.ctrl.write_bar is not None
    assert s2r.ctrl.write_bar in shl.ctrl.wait
    assert shl.ctrl.stall < 15  # no hard-coded 15-cycle stall

    rd = demote(base, REG_FLOOR)
    d_s2r, d_shl = rd.kernel.instructions()[:2]
    assert (s2r.ctrl.write_bar, s2r.ctrl.stall) == (d_s2r.ctrl.write_bar, d_s2r.ctrl.stall)
    assert (shl.ctrl.wait, shl.ctrl.stall) == (d_shl.ctrl.wait, d_shl.ctrl.stall)


class _CorruptingPass(Pass):
    """Deliberately breaks dataflow: emits a spurious global store."""

    name = "corrupt"

    def run(self, ctx):
        ctx.kernel.items.insert(
            len(ctx.kernel.items) - 1,
            Instr("STG", srcs=[RZ, RZ], offset=0x7000),
        )


def test_pipeline_self_check_catches_corruption():
    k = paper_kernel("md5hash")
    ctx = PassContext(k, SharedSpace(), target=32)
    with pytest.raises(PassVerificationError, match="corrupt"):
        PassPipeline([_CorruptingPass()], verify="each").run(ctx)
    # verify="none" tolerates it: callers own verification
    ctx2 = PassContext(k, SharedSpace(), target=32)
    PassPipeline([_CorruptingPass()], verify="none").run(ctx2)
    assert not equivalent(k, ctx2.kernel)


def test_pipeline_counters_advance():
    k = paper_kernel("md5hash")
    before = dict(PIPELINE_COUNTERS)
    demote(k, 32)
    after = dict(PIPELINE_COUNTERS)
    assert after["pipelines"] == before["pipelines"] + 1
    assert after["passes"] >= before["passes"] + 5


class _TaggedPass(Pass):
    """Records which run it is so duplicate-name stats are tellable apart."""

    name = "tagged"

    def __init__(self, tag):
        self.tag = tag

    def run(self, ctx):
        return {"tag": self.tag}


def test_pass_stats_keeps_duplicate_pass_runs():
    """Satellite fix: a pipeline that runs the same pass twice reports both
    runs' stats (``name``, ``name#2``, ...) instead of silently collapsing
    them into whichever ran last."""
    k = paper_kernel("md5hash")
    ctx = PassContext(k, SharedSpace(), target=32)
    PassPipeline(
        [_TaggedPass(1), _TaggedPass(2), _TaggedPass(3)], verify="none"
    ).run(ctx)
    assert [p.name for p in ctx.passes] == ["tagged", "tagged", "tagged"]
    stats = ctx.pass_stats()
    assert list(stats) == ["tagged", "tagged#2", "tagged#3"]
    assert [s["tag"] for s in stats.values()] == [1, 2, 3]


def test_context_reserves_above_reg_count():
    k = paper_kernel("conv")
    ctx = PassContext(k, SharedSpace(), target=32)
    demotion_pipeline(verify="none").run(ctx)
    assert ctx.rdv >= k.reg_count or ctx.rdv != RZ  # reserved, then compacted
    assert ctx.rda == ctx.kernel.rda
