"""Property-based tests (hypothesis) for the spill pass pipeline: every
pipeline *prefix* — the state at each pass boundary — preserves dataflow
equivalence and schedule validity, for random kernels and option sets."""

import os

import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")

from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

from repro_torch.core.isa import equivalent  # noqa: E402
from repro_torch.core.kernelgen import generate, random_profile  # noqa: E402
from repro_torch.core.passes import (  # noqa: E402
    PassContext,
    RegDemOptions,
    aggressive_pipeline,
    demotion_pipeline,
)
from repro_torch.core.regdem import auto_targets  # noqa: E402
from repro_torch.core.sched import verify_schedule  # noqa: E402
from repro_torch.core.spillspace import LocalSpace, SharedSpace  # noqa: E402
from repro_torch.core.strategies import get_strategy, strategy_names  # noqa: E402

#: nightly CI sets REGDEM_PROPERTY_SCALE to sweep a larger input space
SCALE = max(1, int(os.environ.get("REGDEM_PROPERTY_SCALE", "1")))

_slow = settings(
    max_examples=10 * SCALE,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)


def _check_prefixes(original, pipeline, ctx, tag):
    boundaries = []
    pipeline.run(
        ctx,
        observer=lambda p, c: boundaries.append(
            (p.name, verify_schedule(c.kernel), equivalent(original, c.kernel))
        ),
    )
    assert boundaries, "pipeline ran no passes"
    for pass_name, sched_errs, equiv in boundaries:
        assert sched_errs == [], (tag, pass_name, sched_errs[:2])
        assert equiv, (tag, f"dataflow broken after pass {pass_name!r}")


@given(
    seed=st.integers(min_value=0, max_value=10_000),
    strategy=st.sampled_from(["static", "cfg", "conflict"]),
    flags=st.tuples(st.booleans(), st.booleans(), st.booleans(), st.booleans()),
)
@_slow
def test_demotion_pipeline_prefixes(seed, strategy, flags):
    k = generate(random_profile(seed % 30))
    targets = auto_targets(k)
    if not targets:
        return
    b, e, r, s = flags
    opt = RegDemOptions(
        candidate_strategy=strategy,
        bank_avoid=b,
        elim_redundant=e,
        reschedule=r,
        substitute=s,
    )
    ctx = PassContext(k, SharedSpace(), opt, target=targets[0])
    _check_prefixes(k, demotion_pipeline(opt, verify="none"), ctx, opt.label())


@given(
    seed=st.integers(min_value=0, max_value=10_000),
    name=st.sampled_from(strategy_names()),
    combo_index=st.integers(min_value=0, max_value=3),
)
@_slow
def test_registered_strategy_prefixes(seed, name, combo_index):
    """Every registered strategy's pipeline — whatever passes and spill
    space its ``build`` wires up — preserves schedule validity and dataflow
    equivalence at every pass boundary."""
    strat = get_strategy(name)
    k = generate(random_profile(seed % 30))
    if not strat.select(k):
        return
    targets = strat.targets(k, None)
    if not targets:
        return
    combos = strat.option_combos(False)
    combo = combos[combo_index % len(combos)]

    boundaries = []
    strat.build(
        k,
        targets[0],
        combo,
        verify="none",
        observer=lambda p, c: boundaries.append(
            (p.name, verify_schedule(c.kernel), equivalent(k, c.kernel))
        ),
    )
    assert boundaries, "strategy pipeline ran no passes"
    tag = strat.options_label(combo)
    for pass_name, sched_errs, equiv in boundaries:
        assert sched_errs == [], (tag, pass_name, sched_errs[:2])
        assert equiv, (tag, f"dataflow broken after pass {pass_name!r}")


@given(
    seed=st.integers(min_value=0, max_value=10_000),
    shared=st.booleans(),
    max_remat=st.one_of(st.none(), st.integers(min_value=0, max_value=8)),
)
@_slow
def test_aggressive_pipeline_prefixes(seed, shared, max_remat):
    k = generate(random_profile(seed % 30))
    targets = auto_targets(k)
    if not targets:
        return
    space = SharedSpace(check_limit=False) if shared else LocalSpace()
    opt = RegDemOptions(
        candidate_strategy="static",
        bank_avoid=False,
        elim_redundant=False,
        reschedule=False,
        substitute=False,
    )
    ctx = PassContext(
        k, space, opt, target=targets[0], floor=max(targets[0], 0), max_remat=max_remat
    )
    _check_prefixes(k, aggressive_pipeline(verify="none"), ctx, space.name)
