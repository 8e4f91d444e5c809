"""Compile-time performance predictor (paper §4, Fig. 5).

Estimates program cost in *stall cycles* from the binary alone:

1. per-basic-block stall accumulation, scaling each instruction's annotated
   stall by occupancy-driven contention and unit throughput (eq. 2):
   ``stall = inst_stall * occupancy * MAX_THROUGHPUT / inst_throughput``;
2. memory stalls from the barrier tracker: time between barrier set and
   first wait, floored by the memory latency (GL_MEM_STALL / SH_MEM_STALL);
3. loop bodies weighted by ``LOOP_FACTOR`` (10);
4. whole-program adjustment by the empirical occupancy curve (eq. 3):
   ``stall_program = f(occ) / f(occ_max) * stall_count``.

``f`` is fitted once on compute-intensive microbenchmarks whose occupancy is
swept by register usage, exactly as §4 describes — here the measurements
come from the timing simulator instead of a Titan X.

The module also provides the ``naive`` ablation (raw static stall count) the
paper compares against in Fig. 9.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .isa import (
    CFG,
    Instr,
    Kernel,
)
from .occupancy import SMConfig, occupancy_of

#: generic loop weight (paper §4 step two)
LOOP_FACTOR = 10


def _arch_of(kernel: Kernel):
    from repro_torch.arch import arch_of

    return arch_of(kernel)


def estimate_stalls(kernel: Kernel, occupancy: Optional[float] = None) -> float:
    """Fig. 5: whole-program stall estimate at the given occupancy.

    The contention term (eq. 2), the barrier residual latencies, and the
    register banking come from the kernel's architecture."""
    arch = _arch_of(kernel)
    if occupancy is None:
        occupancy = occupancy_of(kernel, arch.sm).occupancy
    cfg = CFG(kernel)
    block_stall: Dict[int, float] = {}

    for blk in cfg.blocks:
        stall = 0.0
        tracker: List[Optional[Tuple[Instr, float]]] = [None] * arch.num_barriers
        for ins in blk.instrs:
            inst_stall = (
                ins.ctrl.stall * occupancy * arch.throughput_ratio(ins.info.klass)
            )
            inst_stall += arch.bank_conflicts(ins)
            # barrier bookkeeping (lines 7-12)
            if ins.ctrl.read_bar is not None:
                tracker[ins.ctrl.read_bar] = (ins, 0.0)
            if ins.ctrl.write_bar is not None:
                tracker[ins.ctrl.write_bar] = (ins, 0.0)
            # waits: residual memory latency (lines 13-19)
            for b in ins.ctrl.wait:
                if tracker[b] is None:
                    continue
                setter, elapsed = tracker[b]
                lat = arch.residual_latency(setter.info.klass)
                if elapsed < lat:
                    stall += lat - elapsed
                tracker[b] = None
            # elapse (lines 20-21)
            for b in range(arch.num_barriers):
                if tracker[b] is not None:
                    tracker[b] = (tracker[b][0], tracker[b][1] + inst_stall)
            stall += inst_stall
        block_stall[blk.index] = stall

    # step two: loop weighting (multiplicative per nesting level)
    total = 0.0
    for blk in cfg.blocks:
        total += block_stall[blk.index] * (LOOP_FACTOR ** blk.loop_depth)
    return total


def naive_stalls(kernel: Kernel) -> float:
    """The Fig. 9 ``naive`` scheme: raw static stall-count sum."""
    return float(sum(ins.ctrl.stall for ins in kernel.instructions()))


def strategy_access_cost(hints, arch) -> float:
    """Predicted cycles one demoted-slot access costs under ``arch``, from
    a strategy's :class:`~repro_torch.core.strategies.StrategyHints` alone — no
    variant built yet.

    The slot load/store pays its access path's latency
    (``hints.latency_class`` names the :class:`~repro_torch.arch.registry.
    LatencyModel` attribute) plus one fixed ALU latency per pack/unpack op
    (``hints.access_overhead``).  The autotuning search breaks exact
    predictor ties toward the strategy with the cheaper access path; the
    paper orderings all share one hints object, so their relative ordering
    is unchanged by this tie-break.
    """
    return (
        getattr(arch.latency, hints.latency_class)
        + hints.access_overhead * arch.latency.alu
    )


# ---------------------------------------------------------------------------
# The empirical occupancy-performance curve f(x) (eq. 3)
# ---------------------------------------------------------------------------

#: Normalized execution time vs occupancy, fitted with
#: :func:`fit_occupancy_curve` (regenerate with
#: ``python -m repro_torch.core.predictor``).  Shape matches Volkov's observation
#: [35]: steep gains up to ~0.5 occupancy, diminishing returns above.
OCCUPANCY_CURVE: List[Tuple[float, float]] = [
    (0.125, 49.154),
    (0.1875, 21.976),
    (0.25, 12.525),
    (0.3125, 8.196),
    (0.5, 3.283),
    (0.625, 2.128),
    (0.75, 1.526),
    (1.0, 1.0),
]


def f_occupancy(x: float, curve: Optional[Sequence[Tuple[float, float]]] = None) -> float:
    """Piecewise-linear interpolation of the occupancy curve."""
    pts = list(curve or OCCUPANCY_CURVE)
    if x <= pts[0][0]:
        return pts[0][1]
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        if x <= x1:
            t = (x - x0) / (x1 - x0)
            return y0 + t * (y1 - y0)
    return pts[-1][1]


def fit_occupancy_curve(threads_per_block: int = 128) -> List[Tuple[float, float]]:
    """Re-fit ``OCCUPANCY_CURVE`` from simulator microbenchmarks.

    One compute-intensive kernel (dependent FMA chains plus a global load
    stream); its occupancy is swept *without changing the instruction
    stream* by padding the register count — "measuring only the impact of
    occupancy on performance" (§4).

    Calibration: the predictor multiplies per-instruction stalls by
    occupancy (eq. 2), so for identical code ``est(x) ∝ x`` and the eq.-3
    curve must satisfy ``measured(x)/measured(1) = f(x)/f(1) * x``, i.e.
    ``f(x) = measured_ratio(x) / x``.  This makes the fitted curve the exact
    inverse correction for the contention term on occupancy-only changes.
    """
    from .isa import Instr
    from .kernelgen import Profile, generate
    from .simcache import DEFAULT_SIM_CACHE

    prof = Profile(
        name="occ_micro",
        target_regs=32,
        threads_per_block=threads_per_block,
        num_blocks=8192,
        shared_size=0,
        regdem_target=32,
        nvcc_spills=0,
        loop_trips=12,
        n_consts=4,
        n_temps=4,
        loads_per_iter=2,
        chase_loads=1,
        seed=1234,
    )
    base = generate(prof)
    variants = []
    for pad_regs in (32, 40, 48, 64, 84, 96, 128, 168, 255):
        k = base.copy()
        if pad_regs > k.reg_count:
            # touch a high register once: same dynamic behaviour, padded
            # register footprint (the occupancy-calculator sees pad_regs)
            k.items.insert(0, Instr("MOV", [pad_regs - 1], [255]))
        variants.append(k)
    # one batched sweep: pad values below reg_count dedup to the base kernel
    # through the cache, the rest share the engine's checkpoint store
    sims = DEFAULT_SIM_CACHE.simulate_batch(variants)
    results: List[Tuple[float, float]] = [
        (sim.occupancy.occupancy, float(sim.total_cycles)) for sim in sims
    ]
    agg: Dict[float, List[float]] = {}
    for occ, t in results:
        agg.setdefault(round(occ, 4), []).append(t)
    pts = sorted((o, sum(v) / len(v)) for o, v in agg.items())
    o_max, t_max = pts[-1]
    out: List[Tuple[float, float]] = []
    prev = float("inf")
    for o, t in pts:
        fx = (t / t_max) / (o / o_max)
        fx = min(fx, prev)  # enforce monotone non-increasing
        prev = fx
        out.append((o, round(fx, 3)))
    return out


# ---------------------------------------------------------------------------
# Variant selection (the §4 contract)
# ---------------------------------------------------------------------------


@dataclass
class Prediction:
    name: str
    stalls: float
    occupancy: float
    adjusted: float


def _launch_occupancy(kernel: Kernel, sm: SMConfig) -> float:
    """Upper bound on achieved occupancy from the launch size alone: a grid
    too small to fill every SM cannot benefit from a higher theoretical
    ceiling (this is why tail-wave benchmarks gain nothing from demotion)."""
    warps_per_block = -(-kernel.threads_per_block // sm.warp_size)
    total_warps = kernel.num_blocks * warps_per_block
    return min(1.0, total_warps / (sm.num_sms * sm.max_warps))


def achieved_occupancy(kernel: Kernel, sm: Optional[SMConfig] = None) -> float:
    """Achieved-occupancy estimate: the theoretical ceiling capped by what
    the launch size can actually fill.  The single definition shared by
    :func:`predict` and the autotuning search, so both paths always score
    variants under the same occupancy model."""
    if sm is None:
        sm = _arch_of(kernel).sm
    return min(occupancy_of(kernel, sm).occupancy, _launch_occupancy(kernel, sm))


def predict(
    variants: Dict[str, Kernel],
    sm: Optional[SMConfig] = None,
    curve: Optional[Sequence[Tuple[float, float]]] = None,
    option_rank: Optional[Dict[str, int]] = None,
) -> Tuple[str, List[Prediction]]:
    """Rank code variants; returns (best_name, all_predictions).

    ``option_rank`` breaks ties toward more enabled performance options
    (paper §5.7: "counting on potential benefits of the enabled options").
    ``sm`` overrides the occupancy limits; by default each variant is
    judged under its own architecture's SM configuration.
    """
    from .simcache import estimate_stalls_cached

    def _sm(k: Kernel) -> SMConfig:
        return sm if sm is not None else _arch_of(k).sm

    occs = {n: achieved_occupancy(k, _sm(k)) for n, k in variants.items()}
    occ_max = max(occs.values())
    preds: List[Prediction] = []
    for n, k in variants.items():
        # content-cached: a variant already analyzed at this occupancy
        # anywhere in the process (e.g. by a previous translation of the
        # same kernel) is served from DEFAULT_SIM_CACHE
        raw = estimate_stalls_cached(k, occs[n])
        adj = f_occupancy(occs[n], curve) / f_occupancy(occ_max, curve) * raw
        preds.append(Prediction(name=n, stalls=raw, occupancy=occs[n], adjusted=adj))
    rank = option_rank or {}
    best = min(preds, key=lambda p: (p.adjusted, -rank.get(p.name, 0)))
    return best.name, preds


def predict_naive(variants: Dict[str, Kernel]) -> str:
    return min(variants, key=lambda n: naive_stalls(variants[n]))


def ranking_agreement(
    predicted: Dict[str, float], measured: Dict[str, float]
) -> float:
    """Pairwise ordering agreement between a predicted cost ranking and a
    measured one (the §5 accuracy claim, as one number).

    For every unordered pair of variants present in both dicts, the pair is
    *concordant* when the predictor orders it the same way the measurement
    does (both tie, or both strictly agree on which is cheaper).  Returns
    concordant / total pairs, 1.0 when fewer than two variants overlap.
    This is what the autotuning search and ``BENCH_search.json`` report as
    ``agreement``, and what the predictor-fidelity test pins.
    """
    names = sorted(set(predicted) & set(measured))
    pairs = concordant = 0
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            pairs += 1
            dp = predicted[a] - predicted[b]
            dm = measured[a] - measured[b]
            if (dp == 0 and dm == 0) or dp * dm > 0:
                concordant += 1
    return concordant / pairs if pairs else 1.0


if __name__ == "__main__":  # pragma: no cover
    pts = fit_occupancy_curve()
    print("OCCUPANCY_CURVE = [")
    for o, t in pts:
        print(f"    ({o}, {t}),")
    print("]")
