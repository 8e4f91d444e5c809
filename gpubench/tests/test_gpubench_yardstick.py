"""The yardstick on the CPU: traffic from the seed, the attention bound's
operations and bytes, model FLOPs, and busy time as a union of intervals."""

import math
import random
from typing import Iterable, List, Tuple

import numpy as np
import pytest
import torch

from gpubench import harness, roofline
from gpubench.reference import model as ref
from gpubench.traffic import lengths
from gpubench.traffic.synthetic_lm import SyntheticLM

def union_seconds(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """The plain version of ``trace.TraceData.busy_s``: seconds of ``[lo, hi]`` covered by at least one of ``intervals``
    (``(start, end)``, any order, overlapping or not)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps_of(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers, longest first."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


CELLS = ["stablelm_3b.prefill_heavy", "qwen2_moe_a2_7b.decode_heavy", "stablelm_3b.chat_single"]


@pytest.mark.parametrize("cell", CELLS)
def test_pool_is_fixed_and_distinct(cell):
    wl = harness.load_json(harness.GPUBENCH / "workloads" / f"{cell}.json")
    pool = lengths.pool(wl["prompts"])
    p = wl["prompts"]
    assert len(set(pool)) == p["pool"] and pool == sorted(pool)
    assert p["min"] <= pool[0] and pool[-1] <= p["max"]
    median = pool[len(pool) // 2]
    assert 0.8 * p["median"] <= median <= 1.25 * p["median"]


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_011, 2**31 + 5])
def test_same_seed_same_traffic(seed):
    pool = lengths.pool({"dist": "lognormal", "median": 256, "sigma": 0.6, "min": 32,
                         "max": 1024, "pool": 32})

    def draw(s):
        ls = lengths.Lengths(pool, s).take(100)
        return ls, lengths.prompts(ls, 50304, lengths.rng(s, 2))

    a, b, c = draw(seed), draw(seed), draw(seed + 1)
    assert a[0] == b[0] and all((x == y).all() for x, y in zip(a[1], b[1]))
    assert a[0] != c[0]
    # every seed serves the same sizes: each round of the pool is a permutation
    assert sorted(a[0][:96]) == sorted(c[0][:96]) == sorted(pool * 3)


def test_synthetic_lm_is_the_programs():
    from repro_torch.data import DataConfig
    from repro_torch.data import SyntheticLM as Program

    ours = SyntheticLM(50304, 256, 2, seed=3_000_000_011)
    theirs = Program(DataConfig(vocab=50304, seq_len=256, global_batch=2, seed=3_000_000_011))
    for i in (0, 5):
        a, b = ours.batch(i), theirs.batch(i)
        assert all((a[k] == b[k]).all() for k in ("tokens", "targets"))


def test_attention_bound_by_hand():
    """Two shapes worked by hand, and the closed form against the tensor form."""
    # prefill: 1,024 queries at 0..1023 in a 4,096-position cache, 32 heads of 80
    flops, nbytes = roofline.attention_row_bound(0, 1024, 4096, 32, 32, 80)
    assert flops == 4 * 32 * 80 * (1024 * 1025 // 2)
    assert nbytes == 2 * 1024 * 32 * 80 * 2 + 2 * 1024 * 32 * 80 * 2 + 4 * (1024 + 4096)
    # decode: one query at position 300, 16 query heads on 4 K / V heads of 128
    flops, nbytes = roofline.attention_row_bound(300, 1, 512, 16, 4, 128)
    assert flops == 4 * 16 * 128 * 301
    assert nbytes == 2 * 16 * 128 * 2 + 2 * 301 * 4 * 128 * 2 + 4 * (1 + 512)
    assert roofline.least_seconds(flops, nbytes) == nbytes / roofline.PEAK_BYTES_PER_S
    for first, rows, cache, hq, hkv, dh in [(0, 37, 64, 4, 2, 16), (20, 3, 40, 2, 2, 32)]:
        q = torch.zeros(1, rows, hq, dh, dtype=torch.bfloat16)
        k = torch.zeros(1, cache, hkv, dh, dtype=torch.bfloat16)
        qpos = torch.arange(first, first + rows)[None]
        kpos = torch.arange(cache)[None]
        b = roofline.bound_visible(q, k, qpos, kpos)
        assert (b["flops"], b["bytes"]) == roofline.attention_row_bound(first, rows, cache, hq,
                                                                        hkv, dh)


def test_serve_flops_by_hand():
    run = harness.load_json(harness.GPUBENCH / "configs" / "stablelm_3b.json")["run"]
    D, F, L, V = 2560, 6912, 32, 50304
    body = L * (4 * D * D + 3 * D * F)
    assert ref.body_params(run) == body
    got = roofline.serve_flops(run, 10, 3)
    attn = 4 * L * 32 * 80
    want = 2 * body * 10 + 2 * D * V + attn * 55 + 2 * (2 * (body + D * V)) + attn * (11 + 12)
    assert got == want
    assert roofline.train_flops(run, 8, 2) == 2 * (6 * (body + D * V) * 8 + 3 * attn * 36)


def test_moe_active_params():
    run = harness.load_json(harness.GPUBENCH / "configs" / "qwen2_moe_a2_7b.json")["run"]
    # Qwen1.5-MoE-A2.7B: about 2.7 B active of 14.3 B, embedding and head included
    active = ref.body_params(run) + ref.head_params(run) + 151936 * 2048
    total = ref.body_params(run, active=False) + ref.head_params(run) + 151936 * 2048
    assert 2.6e9 < active < 2.8e9 and 14.2e9 < total < 14.4e9


def test_union_of_overlapping_intervals():
    """The plain union, against a grid."""
    rng = random.Random(5)
    for _ in range(200):
        ivs = []
        for _ in range(rng.randint(0, 30)):
            s = rng.uniform(-1, 11)
            ivs.append((s, s + rng.expovariate(1.0)))
        busy = union_seconds(ivs, 0.0, 10.0)
        assert 0.0 <= busy <= 10.0
        idle = sum(g1 - g0 for g0, g1 in gaps_of(ivs, 0.0, 10.0))
        assert math.isclose(busy + idle, 10.0, abs_tol=1e-9)
        # a sum of durations would pass the window where streams overlap
        grid = np.linspace(0, 10, 20001)[:-1] + 0.00025
        covered = np.zeros_like(grid, dtype=bool)
        for s, e in ivs:
            covered |= (grid >= s) & (grid < e)
        assert abs(busy - covered.mean() * 10.0) < 0.01
    assert union_seconds([(0, 6), (2, 8), (1, 3)], 0, 10) == 8
    assert gaps_of([(0, 6), (2, 8)], 0, 10) == [(8, 10)]


def test_idle_share_stays_in_bounds():
    from gpubench import trace

    class Run:
        record = {"served": []}

    ops = [("k", 0.0, 0.6), ("k", 0.2, 0.9), ("k", 0.1, 0.5)]   # three streams overlapping
    t = trace.TraceData(trace.Events.of(ops), trace.Events.of([(trace.WINDOW, 0.0, 1.0)]))
    Run.trace = t
    assert math.isclose(t.busy_s, 0.9) and math.isclose(trace.idle_share(Run), 0.1)
    assert sum(e - s for _, s, e in ops) > t.window_s    # what a sum would have read
    assert math.isclose(t.kernel_seconds("k"), 1.7)
    rng = random.Random(3)
    for _ in range(100):   # the arrays' union against the intervals' own
        rows = []
        for _ in range(rng.randint(1, 40)):
            s = rng.uniform(-1, 11)
            rows.append(("op", s, s + rng.expovariate(2.0)))
        t = trace.TraceData(trace.Events.of(rows), trace.Events.of([(trace.WINDOW, 0.0, 10.0)]))
        assert math.isclose(t.busy_s, union_seconds([r[1:] for r in rows], 0, 10),
                            abs_tol=1e-9)
        idle = t.breakdown()["idle_gaps"]
        assert [round(g, 9) for _, g in idle] == [round(b - a, 9) for a, b in
                                                   gaps_of([r[1:] for r in rows], 0, 10)[:10]]


@pytest.mark.parametrize("call_s", [0.38, 2.55, 3.75, 10.8])
def test_schedule_records_a_steady_stretch(call_s):
    """Calls of a closed loop in a 45 s window, as long as each cell's: the
    profiler warms up before it records, records whole calls from a third
    of the window on for about ten seconds, and records at least one."""
    from gpubench import trace

    sched, phases, t = trace.Schedule(45.0), [], 0.0
    while t < 45.0:
        phases.append((t, sched.at(t)[1]))
        t += call_s
    names = [p for _, p in phases]
    on = [t for t, p in phases if p == "on"]
    assert on and on[0] >= 15.0
    assert "warm" in names[:names.index("on")]      # the warm-up comes first
    first, last = names.index("on"), len(names) - names[::-1].index("on")
    assert set(names[first:last]) == {"on"} and set(names[last:]) <= {"off"}
    assert on[-1] + call_s - on[0] >= min(10.0, 45.0 - on[0] - call_s)
    assert on[-1] - on[0] < 10.0                     # stopped at the first boundary past it


def test_tracer_records_only_the_stretch():
    """On the CPU, a window of short calls: the trace holds the recorded
    calls' spans alone, its window spans them, and the phases' rates come
    from every call."""
    import time

    from gpubench import trace

    tracer = trace.Tracer(True, cuda=False, seconds=4.0)
    calls, start = [], time.perf_counter()
    while time.perf_counter() - start < 4.0:
        phase = tracer.boundary(time.perf_counter() - start)
        t0 = time.perf_counter()
        with tracer.span("gpubench.serve"):
            torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.05)
        calls.append((phase, time.perf_counter() - t0, 10))
    tracer.end()
    on = [c for c in calls if c[0] == "on"]
    assert on and tracer.read_s is not None
    host = tracer.data.host
    spans = np.sum(host.idx == host.names.index("gpubench.serve"))
    assert spans == len(on)
    assert sum(c[1] for c in on) <= tracer.data.window_s < sum(c[1] for c in on) + 0.1
    rates = trace.phase_rates(calls)
    assert rates["on"]["calls"] == len(on) and set(rates) == {"off", "warm", "on"}
    assert math.isclose(rates["on"]["tokens_per_s"], 10 * len(on) / sum(c[1] for c in on))
