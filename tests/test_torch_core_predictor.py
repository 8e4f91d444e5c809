"""Performance-predictor tests (paper §4, Fig. 5/9)."""

import pytest

from repro_torch.core.kernelgen import PAPER_BENCHMARKS, paper_kernel
from repro_torch.core.predictor import (
    OCCUPANCY_CURVE,
    estimate_stalls,
    f_occupancy,
    naive_stalls,
    predict,
    predict_naive,
    ranking_agreement,
)
from repro_torch.core.variants import make_variants


def test_occupancy_curve_monotone():
    ys = [y for _, y in OCCUPANCY_CURVE]
    assert all(a >= b for a, b in zip(ys, ys[1:]))
    assert OCCUPANCY_CURVE[-1][1] == pytest.approx(1.0)


def test_f_occupancy_interpolation():
    lo = OCCUPANCY_CURVE[0]
    hi = OCCUPANCY_CURVE[-1]
    assert f_occupancy(lo[0] / 2) == lo[1]          # clamp below
    assert f_occupancy(hi[0] + 1) == hi[1]          # clamp above
    mid = (OCCUPANCY_CURVE[2][0] + OCCUPANCY_CURVE[3][0]) / 2
    assert (
        min(OCCUPANCY_CURVE[3][1], OCCUPANCY_CURVE[2][1])
        <= f_occupancy(mid)
        <= max(OCCUPANCY_CURVE[3][1], OCCUPANCY_CURVE[2][1])
    )


def test_estimate_scales_with_loop_factor():
    k = paper_kernel("conv")
    total = estimate_stalls(k, occupancy=0.75)
    assert total > naive_stalls(k)  # loops weighted x10 + latency residuals


def test_estimate_monotone_in_occupancy_contention():
    # eq. 2: same code at higher occupancy sees more contention stalls
    k = paper_kernel("md5hash")
    assert estimate_stalls(k, 1.0) > estimate_stalls(k, 0.5)


def test_predictor_picks_regdem_for_spill_heavy():
    vs = make_variants(PAPER_BENCHMARKS["cfd"])
    best, preds = predict({n: v.kernel for n, v in vs.items()})
    assert best == "regdem"
    names = {p.name for p in preds}
    assert names == set(vs)


def test_predictor_avoids_worst_case():
    """§5.7: the predictor helps avoid the worst-case scenario.  For
    gaussian (tail-wave launch) it must not pick a deep-spill variant."""
    vs = make_variants(PAPER_BENCHMARKS["gaussian"])
    best, _ = predict({n: v.kernel for n, v in vs.items()})
    assert best != "local-shared"


def test_predictor_accuracy_band():
    """Predictor must reach >=90% of the oracle geomean (paper: 99%)."""
    import math

    from repro_torch.core.simulator import simulate, speedup

    logs_o, logs_p = [], []
    for name, prof in PAPER_BENCHMARKS.items():
        vs = make_variants(prof)
        kernels = {n: v.kernel for n, v in vs.items()}
        sims = {n: simulate(k) for n, k in kernels.items()}
        base = sims["nvcc"]
        sp = {n: speedup(base, sims[n]) for n in kernels}
        oracle = max(sp.values())
        best, _ = predict(kernels)
        logs_o.append(math.log(oracle))
        logs_p.append(math.log(sp[best]))
    gm_o = math.exp(sum(logs_o) / len(logs_o))
    gm_p = math.exp(sum(logs_p) / len(logs_p))
    assert gm_p / gm_o >= 0.90, (gm_p, gm_o)


#: Pinned predictor-vs-simulator pairwise ranking agreement per benchmark
#: (9 benchmarks x 5 variants = 10 variant pairs each, so every value is a
#: multiple of 0.1).  The §5 accuracy claim as numbers: a regression in
#: ``estimate_stalls`` (or the occupancy curve, or the eq.-3 adjustment)
#: shifts these and fails loudly instead of silently degrading choices.
PINNED_AGREEMENT = {
    "cfd": 0.6, "qtc": 0.9, "md5hash": 0.9, "md": 0.8, "gaussian": 0.7,
    "conv": 0.3, "nn": 0.9, "pc": 0.8, "vp": 0.9,
}


def test_ranking_agreement_helper():
    assert ranking_agreement({"a": 1.0, "b": 2.0}, {"a": 10, "b": 20}) == 1.0
    assert ranking_agreement({"a": 1.0, "b": 2.0}, {"a": 20, "b": 10}) == 0.0
    # ties agree only with ties
    assert ranking_agreement({"a": 1.0, "b": 1.0}, {"a": 5, "b": 5}) == 1.0
    assert ranking_agreement({"a": 1.0, "b": 1.0}, {"a": 5, "b": 6}) == 0.0
    # disjoint / single-name inputs degenerate to perfect agreement
    assert ranking_agreement({"a": 1.0}, {"b": 2.0}) == 1.0


@pytest.mark.parametrize("name", sorted(PAPER_BENCHMARKS))
def test_predictor_fidelity_pinned(name):
    """Predictor-vs-simulator ranking agreement across the five §5.3
    variants, pinned per benchmark."""
    from repro_torch.core.simcache import simulate_cached

    vs = make_variants(PAPER_BENCHMARKS[name])
    kernels = {n: v.kernel for n, v in vs.items()}
    _, preds = predict(kernels)
    predicted = {p.name: p.adjusted for p in preds}
    measured = {n: simulate_cached(k).total_cycles for n, k in kernels.items()}
    assert ranking_agreement(predicted, measured) == pytest.approx(
        PINNED_AGREEMENT[name], abs=1e-12
    )


def test_pinned_agreement_floor_guard():
    """Guard on the pins themselves (live values are checked per benchmark
    by test_predictor_fidelity_pinned): nobody may "fix" a fidelity
    regression by editing the pinned values below the headline floor."""
    assert sum(PINNED_AGREEMENT.values()) / len(PINNED_AGREEMENT) >= 0.75


def test_naive_differs_from_full_predictor():
    vs = make_variants(PAPER_BENCHMARKS["nn"])
    kernels = {n: v.kernel for n, v in vs.items()}
    nv = predict_naive(kernels)
    full, _ = predict(kernels)
    # the naive scheme ignores occupancy and latency residuals; on nn it
    # keeps the baseline while the full predictor exploits occupancy
    assert nv == "nvcc"
    assert full != "nvcc"
